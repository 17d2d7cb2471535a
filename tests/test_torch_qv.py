"""The qv slice on the CPU: the port's chunk meta and device post
(models/qv._qv_chunk_meta, ops/countstep.qv_join_post) against the JAX
package's on the same inputs, and `qv`'s stdout byte-identical to
`yak_tpu`'s for a fixed-length-read FASTQ (the periodic 2-plane path)
and a multi-line FASTA with N runs, short sequences and contigs that
span two and three chunks (the 3-plane path), with -p, -E, -l, -f and
-e, through the -E budget overflow, through a table carried over with
`from_arrays`, and through the CLI.  Integers and numpy float64 on the
host: every comparison is exact."""

import contextlib
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_lookup_cases import CHUNK, write_contigs, write_reads
from yak_tpu import cli as jax_cli
from yak_tpu.io.chunks import ChunkSource as JaxChunkSource
from yak_tpu.models import count as jcount
from yak_tpu.models import qv as jqv
from yak_tpu.ops import countstep as jcs
from yak_tpu.table import KmerTable as JaxTable
from yak_tpu_torch.io.chunks import ChunkSource
from yak_tpu_torch.models import qv as pqv
from yak_tpu_torch.ops import countstep as pcs
from yak_tpu_torch.table import KmerTable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The FASTQ, the FASTA and the `.yak` table that `yak_tpu` counts
    from the FASTQ."""
    d = tmp_path_factory.mktemp("qv_inputs")
    fq, fa, yak = str(d / "reads.fq"), str(d / "contigs.fa"), str(d / "t.yak")
    write_reads(fq)
    write_contigs(fa)
    jcount.count_file(fq, jcount.CountOpts(k=31, chunk_size=CHUNK)).dump(yak)
    return {"fastq": fq, "fasta": fa, "yak": yak}


def _qv_text(mod, table, path, **opts):
    buf = io.StringIO()
    mod.main_qv(mod.QvOpts(chunk_size=CHUNK, **opts), table, path, out=buf)
    return buf.getvalue()


def _both(inputs, kind, **opts):
    want = _qv_text(jqv, JaxTable.restore(inputs["yak"]), inputs[kind],
                    **opts)
    got = _qv_text(pqv, KmerTable.restore(inputs["yak"], "cpu"),
                   inputs[kind], **opts)
    return got, want


def test_chunk_meta_matches_jax(inputs):
    """_qv_chunk_meta over every chunk of the FASTA (carries, middle
    pieces, spanning contigs) from both packages' chunk sources."""
    k, M, ns = 31, CHUNK - 30, 1 << 12
    carries = [None, None]
    n_mid = n_carry = 0
    for pp, jp in zip(ChunkSource(inputs["fasta"], CHUNK, k,
                                  with_meta="records"),
                      JaxChunkSource(inputs["fasta"], CHUNK, k,
                                     with_meta="records",
                                     force_python=True)):
        pm, pinfo, carries[0] = pqv._qv_chunk_meta(pp, M, ns, carries[0], 0)
        jm, jinfo, carries[1] = jqv._qv_chunk_meta(jp, M, ns, carries[1], 0)
        np.testing.assert_array_equal(pm, jm)
        assert pinfo == jinfo and carries[0] == carries[1]
        n_mid += pinfo[2] and pinfo[4] == 0
        n_carry += pinfo[3]
    assert n_mid >= 1 and n_carry >= 3


def _seeded_step(rng, M, ns, kind):
    """A seeded (vals, valid, meta) of one chunk: `kind` is "plain",
    "head" (settles a carried sequence) or "mid" (a middle piece)."""
    vals = rng.integers(-1, 40, M).astype(np.int32)
    vals[rng.random(M) < 0.3] = 0
    valid = rng.random(M) < 0.9
    nseq = int(rng.integers(2, ns))
    starts = np.sort(rng.choice(M, nseq, replace=False)).astype(np.int32)
    starts[0] = 0
    meta = np.full(2 * ns + 6, M, np.int32)
    meta[:nseq] = starts
    meta[ns + 1:2 * ns + 1] = 0
    meta[ns + 1:ns + 1 + nseq] = rng.random(nseq) < 0.8
    cont = int(rng.random() < 0.7)
    if kind == "mid":
        tail = (0, 0, 0, 1, 1)
    else:
        tail = (int(starts[1]) if kind == "head" else 0,
                int(starts[-1]) if cont else M, nseq - 1 if cont else 0,
                int(rng.random() < 0.8), cont)
    meta[2 * ns + 1:] = tail
    return vals, valid, meta


@pytest.mark.parametrize("emit_ek", [False, True])
def test_qv_join_post_matches_jax(emit_ek):
    """The port's post (lane-order values in) against the JAX JOIN post
    (get_qv_join_post, fed a key-ordered value stream and its index
    payload), chained over chunks so the device fold state carries."""
    rng = np.random.default_rng(77)
    M, ns, min_frac = 6000, 16, 0.5
    jst = (jnp.zeros(1024, jnp.int64), jnp.int32(-1), jnp.int32(0),
           jnp.zeros(1024, jnp.int64))
    pst = (torch.zeros(1024, dtype=torch.int64),
           torch.tensor(-1, dtype=torch.int32),
           torch.tensor(0, dtype=torch.int32),
           torch.zeros(1024, dtype=torch.int64))
    jpost = jcs.get_qv_join_post(31, ns, M, min_frac=min_frac,
                                 emit_ek=emit_ek)
    for kind in ("plain", "head", "mid", "head", "plain", "mid"):
        vals, valid, meta = _seeded_step(rng, M, ns, kind)
        perm = rng.permutation(M).astype(np.int32)   # key order -> lane
        jo = jpost(jnp.asarray(vals[perm]), jnp.asarray(perm[::-1].copy()),
                   jnp.asarray(valid), jnp.asarray(meta), *jst)
        po = pcs.qv_join_post(torch.from_numpy(vals),
                              torch.from_numpy(valid),
                              torch.from_numpy(meta), pst, ns, M, min_frac,
                              emit_ek)
        assert len(jo) == len(po)
        for j, (a, b) in enumerate(zip(jo, po)):
            a, b = np.asarray(a), b.numpy()
            if emit_ek and j == 6:     # markers: the first n are defined
                n = int(po[7])
                a, b = a[:n].astype(np.int64), b[:n].astype(np.int64)
            np.testing.assert_array_equal(b, a, err_msg=f"{kind} out {j}")
        jst, pst = jo[:4], po[:4]
    assert int(pst[0].sum()) > 0


@pytest.mark.parametrize("kind,opts", [
    ("fastq", {}),
    ("fastq", {"print_each": True, "print_err_kmer": True}),
    ("fasta", {"print_each": True}),
    ("fasta", {"print_each": True, "print_err_kmer": True, "min_len": 300,
               "min_frac": 0.7, "fpr": 0.001}),
])
def test_main_qv_stdout_matches_jax(inputs, kind, opts):
    got, want = _both(inputs, kind, **opts)
    assert got == want
    assert got.count("\nCT\t") == 1024
    if opts.get("print_each"):
        assert got.count("SQ\t") > 30
    if opts.get("print_err_kmer") and kind == "fasta":
        # (the table holds every k-mer of the reads: they give no EK row)
        assert got.count("EK\t") > 100


def test_err_kmer_budget_overflow_matches_jax(inputs, monkeypatch):
    """-E past the marker budget: the JAX package re-scans the chunk, the
    port reads the per-lane values it holds; the text is the same."""
    monkeypatch.setattr(jcs, "QV_MAX_EK", 8)
    monkeypatch.setattr(pcs, "QV_MAX_EK", 8)
    for step in (jcs.get_qv_step, jcs.get_qv_join_post):
        step.cache_clear()
    try:
        got, want = _both(inputs, "fasta", print_each=True,
                          print_err_kmer=True)
    finally:
        for step in (jcs.get_qv_step, jcs.get_qv_join_post):
            step.cache_clear()
    assert got == want and got.count("EK\t") > 100


def test_from_arrays_table_matches_jax(inputs):
    """A table carried over from `yak_tpu` with from_arrays."""
    jt = JaxTable.restore(inputs["yak"])
    jt.flush()
    pt = KmerTable.from_arrays(np.asarray(jt.keys), np.asarray(jt.cnt),
                               int(jt.size), jt.k, jt.pre, "cpu")
    assert (_qv_text(pqv, pt, inputs["fasta"], print_each=True)
            == _qv_text(jqv, jt, inputs["fasta"], print_each=True))


def test_cli_matches_jax(inputs):
    args = ["qv", f"-K{CHUNK}", "-p", "-E", "-l", "200", inputs["yak"],
            inputs["fasta"]]
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "yak_tpu_torch",
                          "--device", "cpu", *args],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[M::main] CMD: yak_tpu_torch qv" in res.stderr
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_cli.main(args) == 0
    assert res.stdout == buf.getvalue()
