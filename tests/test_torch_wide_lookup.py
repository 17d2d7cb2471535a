"""Lookups against k >= 32 tables on the CPU (the wide JOIN): the port's
lookup step (`yak_tpu_torch.ops.countstep.lookup_chunk`, wide-encoded
queries through the merge-JOIN) against the JAX package's non-JOIN
lookup (`sorttable.lookup_impl(packable=False)`, which its single-device
steps take at k > 31) on hand-made 64-bit hashes, a raw 0xFF..FF among
them, and the stdout of qv -p, chkerr, triobin -p and trioeval on k = 33
tables byte-identical to `yak_tpu`'s, on both of the port's engines.
Exact comparisons."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lookup_cases
import torch_trio_cases
from yak_tpu.models import chkerr as jch
from yak_tpu.models import count as jcount
from yak_tpu.models import qv as jqv
from yak_tpu.models import trio as jtrio
from yak_tpu.ops import sorttable as jst
from yak_tpu.table import KmerTable as JaxTable
from yak_tpu_torch.models import chkerr as pch
from yak_tpu_torch.models import qv as pqv
from yak_tpu_torch.models import trio as ptrio
from yak_tpu_torch.ops import countstep as pcs
from yak_tpu_torch.ops.keys import u64_to_torch
from yak_tpu_torch.table import KmerTable

K = 33
CHUNK = torch_lookup_cases.CHUNK
ALL_ONES = np.uint64((1 << 64) - 1)


@pytest.mark.parametrize("psort", [False, True])
def test_wide_lookup_matches_jax(monkeypatch, psort):
    """Raw 64-bit query hashes (half of them table keys, keys >= 2^63
    and 0xFF..FF among them, some invalid lanes) through the port's
    lookup step, against lookup_impl on the same hashes: the port clamps
    the query 0xFF..FF as the table's key, so it finds it, as the JAX
    package finds it unclamped."""
    rng = np.random.default_rng(33)
    keys = np.unique(np.concatenate([
        rng.integers(0, 1 << 64, 4000, dtype=np.uint64),
        [np.uint64(1 << 63), ALL_ONES]]))
    assert keys[-1] == ALL_ONES and (keys < (1 << 63)).any()
    cnt = rng.integers(0, 16, len(keys)).astype(np.int32)
    cap = 1 << 13
    tk = np.zeros(cap, np.uint64)
    tc = np.full(cap, -1, np.int32)
    tk[:len(keys)], tc[:len(keys)] = keys, cnt
    h = np.concatenate([rng.choice(keys, 3000),
                        rng.integers(0, 1 << 64, 3000, dtype=np.uint64),
                        [ALL_ONES, ALL_ONES]])
    h = h[rng.permutation(len(h))]
    valid = rng.random(len(h)) < 0.97
    valid[h == ALL_ONES] = True
    want = np.asarray(jst.lookup_impl(jnp.asarray(tk), jnp.asarray(tc),
                                      jnp.int32(len(keys)), jnp.asarray(h),
                                      jnp.asarray(valid), packable=False))
    table = KmerTable.from_arrays(tk, tc, len(keys), K, 10, "cpu")
    monkeypatch.setattr(pcs, "extract", lambda carg, k: (
        u64_to_torch(h), torch.from_numpy(valid)))
    vals, pvalid = pcs.lookup_chunk(None, K, table.keys, table.cnt,
                                    table.size, psort=psort)
    np.testing.assert_array_equal(pvalid.numpy(), valid)
    np.testing.assert_array_equal(vals.numpy(), want)
    assert (want[h == ALL_ONES] == cnt[-1]).all()
    assert (want >= 0).sum() > 2500


@pytest.fixture(scope="module")
def lookup_inputs(tmp_path_factory):
    """tests/torch_lookup_cases.py's FASTQ and FASTA, and the k = 33
    table `yak_tpu` counts from the FASTQ."""
    d = tmp_path_factory.mktemp("wide_lookup")
    fq, fa, yak = str(d / "reads.fq"), str(d / "contigs.fa"), str(d / "t.yak")
    torch_lookup_cases.write_reads(fq)
    torch_lookup_cases.write_contigs(fa)
    jcount.count_file(fq, jcount.CountOpts(k=K, chunk_size=CHUNK)).dump(yak)
    return {"fastq": fq, "fasta": fa, "yak": yak}


@pytest.fixture(scope="module")
def trio_inputs(tmp_path_factory):
    """tests/torch_trio_cases.py's child FASTA and the k = 33 pat and
    mat tables `yak_tpu` counts from the haplotypes' reads."""
    d = tmp_path_factory.mktemp("wide_trio")
    pat, mat, _g = torch_trio_cases.haplotypes()
    paths = {"child": str(d / "child.fa")}
    torch_trio_cases.write_child(paths["child"])
    ins = torch_trio_cases.PAT_INS_AT
    for name, hap, seed, tile in (
            ("pat", pat, 1, (ins, ins + torch_trio_cases.PAT_INS)),
            ("mat", mat, 2, None)):
        fq = str(d / f"{name}.fq")
        torch_trio_cases.write_reads(fq, hap, seed, tile)
        paths[name] = str(d / f"{name}.yak")
        jcount.count_file(fq, jcount.CountOpts(k=K, chunk_size=CHUNK)) \
            .dump(paths[name])
    return paths


def _lookup_text(mod, cmd, table, path):
    buf = io.StringIO()
    if cmd == "qv":
        mod.main_qv(mod.QvOpts(chunk_size=CHUNK, print_each=True), table,
                    path, out=buf)
    elif cmd == "chkerr":
        mod.main_chkerr(mod.ChkerrOpts(chunk_size=CHUNK), table, path,
                        out=buf)
    else:
        fn = mod.main_triobin if cmd == "triobin" else mod.main_trioeval
        fn(mod.TrioOpts(print_diff=cmd == "triobin"), table, path, out=buf,
           chunk_cap=CHUNK)
    return buf.getvalue()


@pytest.mark.parametrize("psort", [False, True])
@pytest.mark.parametrize("cmd", ["qv", "chkerr"])
def test_qv_chkerr_k33_match_jax(lookup_inputs, monkeypatch, cmd, psort):
    """qv -p and chkerr of the contigs (chunk-spanning, N runs) against a
    k = 33 table: the JAX package on its default engine, the port on its
    default engine or under YAK_TPU_PSORT=1."""
    monkeypatch.delenv("YAK_TPU_PSORT", raising=False)
    mods = (jqv, pqv) if cmd == "qv" else (jch, pch)
    want = _lookup_text(mods[0], cmd, JaxTable.restore(lookup_inputs["yak"]),
                        lookup_inputs["fasta"])
    if psort:
        monkeypatch.setenv("YAK_TPU_PSORT", "1")
    got = _lookup_text(mods[1], cmd,
                       KmerTable.restore(lookup_inputs["yak"], "cpu"),
                       lookup_inputs["fasta"])
    assert got == want and want.count("\n") > 20


@pytest.mark.parametrize("psort", [False, True])
@pytest.mark.parametrize("cmd", ["triobin", "trioeval"])
def test_trio_k33_matches_jax(trio_inputs, monkeypatch, cmd, psort):
    """triobin -p and trioeval against k = 33 trio tables, the JAX
    package's and the port's `load_trio_tables` of the same files."""
    monkeypatch.delenv("YAK_TPU_PSORT", raising=False)
    files = (trio_inputs["pat"], trio_inputs["mat"])
    jtab = jtrio.load_trio_tables(*files, jtrio.TrioOpts())
    ptab = ptrio.load_trio_tables(*files, ptrio.TrioOpts(), "cpu")
    assert jtab.k == ptab.k == K
    for a, b in zip(ptab.items(), jtab.items()):
        np.testing.assert_array_equal(a, b)
    want = _lookup_text(jtrio, cmd, jtab, trio_inputs["child"])
    if psort:
        monkeypatch.setenv("YAK_TPU_PSORT", "1")
    got = _lookup_text(ptrio, cmd, ptab, trio_inputs["child"])
    assert got == want and want.count("\n") > 30
