"""The trio slice on the CPU: the port's restore-into (the OR merge of
`load_trio_tables`), triobin's device reductions and `-p` markers, and
trioeval's run markers with their compaction and their psort form,
against the JAX package's (`get_triobin_join_post`,
`get_trioeval_mark_mid` + `run_mark_compact`, the psort mids with their
marker sorts, the Pallas kernels in interpret mode); and the stdout of
`triobin` and `trioeval` byte-identical to `yak_tpu`'s at the smallest
chunk, with contigs across chunk edges, under both of the port's
engines, through the marker-budget overflow and through the CLI.  Every
value is an integer or a string: all comparisons are exact."""

import contextlib
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_trio_cases import (CHUNK, PAT_INS, PAT_INS_AT, haplotypes,
                              write_child, write_reads)
from yak_tpu import cli as jax_cli
from yak_tpu.models import count as jcount
from yak_tpu.models import trio as jtrio
from yak_tpu.ops import countstep as jcs
from yak_tpu_torch import cli
from yak_tpu_torch.models import trio as ptrio
from yak_tpu_torch.ops import countstep as pcs
from yak_tpu_torch.ops import sorttable as psorttable
from yak_tpu_torch.table import KmerTable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The pat and mat `.yak` tables that `yak_tpu` counts from the two
    haplotypes' reads (k = 31), and the child FASTA."""
    d = tmp_path_factory.mktemp("trio_inputs")
    pat, mat, _g = haplotypes()
    paths = {"child": str(d / "child.fa")}
    write_child(paths["child"])
    for name, hap, seed, tile in (
            ("pat", pat, 1, (PAT_INS_AT, PAT_INS_AT + PAT_INS)),
            ("mat", mat, 2, None)):
        fq = str(d / f"{name}.fq")
        write_reads(fq, hap, seed, tile)
        paths[name] = str(d / f"{name}.yak")
        jcount.count_file(fq, jcount.CountOpts(k=31, chunk_size=CHUNK)) \
            .dump(paths[name])
    return paths


@pytest.fixture(scope="module")
def tables(inputs):
    """Both packages' trio tables at the default (min_cnt, mid_cnt)."""
    return (jtrio.load_trio_tables(inputs["pat"], inputs["mat"],
                                   jtrio.TrioOpts()),
            ptrio.load_trio_tables(inputs["pat"], inputs["mat"],
                                   ptrio.TrioOpts(), "cpu"))


_JAX_TEXT = {}


def _run(mod, cmd, table, path, **opts):
    buf = io.StringIO()
    fn = mod.main_triobin if cmd == "triobin" else mod.main_trioeval
    fn(mod.TrioOpts(**opts), table, path, out=buf, chunk_cap=CHUNK)
    return buf.getvalue()


def _jax_text(inputs, tables, cmd, opts):
    """The JAX package's text of a case, computed once a module."""
    key = (cmd, tuple(sorted(opts.items())))
    if key not in _JAX_TEXT:
        _JAX_TEXT[key] = _run(jtrio, cmd, tables[0], inputs["child"], **opts)
    return _JAX_TEXT[key]


@pytest.mark.parametrize("min_cnt,mid_cnt", [(2, 5), (1, 1), (3, 3)])
def test_restore_into_matches_jax(inputs, min_cnt, mid_cnt):
    """load_trio_tables: the pat flags, then the mat flags ORed in (the
    haplotypes share most k-mers, so most keys get both); keys, values,
    tot and hist as the JAX package's; and the same table through
    from_arrays of the JAX table's items."""
    jt = jtrio.load_trio_tables(inputs["pat"], inputs["mat"],
                                jtrio.TrioOpts(min_cnt=min_cnt,
                                               mid_cnt=mid_cnt))
    pt = ptrio.load_trio_tables(inputs["pat"], inputs["mat"],
                                ptrio.TrioOpts(min_cnt=min_cnt,
                                               mid_cnt=mid_cnt), "cpu")
    jh, jc = jt.items()
    ph, pc = pt.items()
    np.testing.assert_array_equal(ph, jh)
    np.testing.assert_array_equal(pc, jc)
    assert pt.tot == jt.tot and pt.tot > 10000
    np.testing.assert_array_equal(pt.hist(), jt.hist())
    both = ((jc & 3) > 0) & ((jc >> 2) > 0)
    assert both.sum() > 1000 and ((jc & 3) == 0).sum() > 100
    ft = KmerTable.from_arrays(jh, jc, len(jh), 31, jt.pre, "cpu")
    for a, b in zip(ft.items(), (ph, pc)):
        np.testing.assert_array_equal(a, b)


def test_restore_into_refuses_other_k(inputs, tmp_path):
    t = KmerTable.restore(inputs["pat"], "cpu")
    other = KmerTable(33, device="cpu")
    other.dump(str(tmp_path / "k33.yak"))
    with pytest.raises(ValueError, match="k=33"):
        KmerTable.restore(str(tmp_path / "k33.yak"), "cpu", into=t)


@pytest.mark.parametrize("case", ["runs", "sparse", "none", "all"])
def test_last_set_lane_matches_cummax(case):
    """countstep.last_set_lane, and the scatter form it takes on the
    card, against the running maximum it stands for (numpy's
    maximum.accumulate of the set lanes, -1 before the first)."""
    rng = np.random.default_rng(len(case))
    n = 5000
    mask = {"runs": np.repeat(rng.random(400) < 0.5,
                              rng.integers(1, 30, 400))[:n],
            "sparse": rng.random(n) < 0.01,
            "none": np.zeros(n, bool),
            "all": np.ones(n, bool)}[case]
    mask = np.resize(mask, n)
    want = np.maximum.accumulate(np.where(mask, np.arange(n), -1))
    for fn in (pcs.last_set_lane, psorttable.last_set_lane_scatter):
        got = fn(torch.from_numpy(mask))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _value_stream(seed, M):
    """Seeded lane values in runs (pat-strong 2, mat-strong 8, both 10,
    weak classes, absent -1, a non-trio 30), with a pat-strong run from
    lane 0 and a mat-strong run that ends at `we`; and the validity."""
    rng = np.random.default_rng(seed)
    palette = np.array([2, 8, 10, 1, 4, 0, -1, 6, 9, 30], np.int32)
    runs = rng.geometric(1 / 25, M)
    vals = np.repeat(rng.choice(palette, len(runs),
                                p=[.3, .3, .06, .06, .06, .06, .06, .04,
                                   .04, .02]), runs)[:M]
    we = M - 37
    vals[:61] = [2] * 60 + [0]
    vals[we - 51:we + 1] = [0] + [8] * 51
    valid = rng.random(M) < 0.995
    valid[:61] = valid[we - 51:we + 1] = True
    return vals, valid, we


def _meta(rng, M, we, ns=4096):
    """triobin's meta: record starts clipped to M (one at 0, one past
    M), then M, then we."""
    starts = np.sort(rng.choice(np.arange(1, M), 40, replace=False))
    meta = np.full(ns + 2, M, np.int32)
    meta[:42] = np.concatenate([[0], starts, [M + 5]])
    meta[:42] = np.minimum(meta[:42], M)
    meta[-1] = we
    return meta


def _jax_lanes(vals, seed):
    """The JOIN's outputs as plookup_post reads them: values in a
    permuted order and the matching payload."""
    perm = np.random.default_rng(seed).permutation(len(vals))
    return jnp.asarray(vals[perm]), jnp.asarray(perm[::-1].astype(np.int32))


@pytest.mark.parametrize("emit_diff", [False, True])
def test_triobin_reduce_matches_jax(emit_diff):
    M, k, ns = 20000, 31, 4096
    vals, valid, we = _value_stream(5, M)
    meta = _meta(np.random.default_rng(6), M, we, ns)
    ov, pay = _jax_lanes(vals, 7)
    want = jcs.get_triobin_join_post(k, ns, M, emit_diff=emit_diff)(
        ov, pay, jnp.asarray(valid), jnp.asarray(meta))
    flag, typ = pcs.trio_types(torch.from_numpy(vals),
                               torch.from_numpy(valid))
    got = pcs.triobin_reduce(flag, typ, torch.from_numpy(valid),
                             torch.from_numpy(meta), k, M).numpy()
    np.testing.assert_array_equal(got[:8 * ns].reshape(8, ns),
                                  np.asarray(want[0]))
    np.testing.assert_array_equal(got[8 * ns:], np.asarray(want[1]))
    assert got[-4:].tolist() == [1, 60, 2, 51]
    assert np.asarray(want[0])[6:].sum() > 1000        # streak sums
    if not emit_diff:
        return
    dn = int(want[3])
    dkey = np.asarray(want[2])[:dn]
    khi, dpay, n = pcs.triobin_diff_mid(flag, torch.from_numpy(valid), M)
    assert int(n) == dn > 1000
    for lanes, flags in (pcs.run_mark_compact(khi, dpay),
                         pcs.run_diff_sort(khi, dpay)):
        np.testing.assert_array_equal(lanes[:dn].numpy(),
                                      (dkey >> np.uint64(4)).astype(np.int32))
        np.testing.assert_array_equal(flags[:dn].numpy(),
                                      (dkey & np.uint64(15)).astype(np.int32))
    assert (flags[:dn] == 30 & 15).any()


def test_triobin_psort_markers_match_jax():
    """The -p markers of the psort forms: get_triobin_psort_mid's u32
    plane through run_marker_psort1 (the Pallas sort in interpret mode)
    and the port's run_diff_sort."""
    M, k, ns = 6000, 31, 4096
    vals, valid, we = _value_stream(8, M)
    meta = _meta(np.random.default_rng(9), M, we, ns)
    Bpad = jcs.qv_psort_pad(M)
    vpad = np.concatenate([vals, np.zeros(Bpad - M, np.int32)])
    o = jcs.get_triobin_psort_mid(k, ns, M, Bpad, emit_diff=True)(
        jnp.asarray(vpad), jnp.asarray(valid), jnp.asarray(meta))
    dn = int(o[3])
    dkey = np.asarray(jcs.run_marker_psort1(o[2], jcs.TRIOBIN_MAX_DIFF,
                                            interpret=True))[:dn]
    flag, _typ = pcs.trio_types(torch.from_numpy(vals),
                                torch.from_numpy(valid))
    khi, dpay, n = pcs.triobin_diff_mid(flag, torch.from_numpy(valid), M)
    lanes, flags = pcs.run_diff_sort(khi, dpay)
    assert int(n) == dn > 100
    np.testing.assert_array_equal(lanes[:dn].numpy(),
                                  (dkey >> 4).astype(np.int32))
    np.testing.assert_array_equal(flags[:dn].numpy(),
                                  (dkey & 15).astype(np.int32))


@pytest.mark.parametrize("min_n", [1, 2, 5])
def test_trioeval_mark_mid_and_compaction_match_jax(min_n):
    M = 20000
    vals, valid, we = _value_stream(10 + min_n, M)
    ov, pay = _jax_lanes(vals, 11)
    jkhi, jpay, jn = jcs.get_trioeval_mark_mid(31, min_n, M)(
        ov, pay, jnp.asarray(valid), jnp.asarray([we], np.int32))
    flag, typ = pcs.trio_types(torch.from_numpy(vals),
                                torch.from_numpy(valid))
    khi, ppay, n = pcs.trioeval_mark_mid(typ, we, min_n, M)
    n = int(n)
    assert n == int(jn) > 100
    np.testing.assert_array_equal(khi.numpy(), np.asarray(jkhi).view(np.int32))
    np.testing.assert_array_equal(ppay.numpy(), np.asarray(jpay))
    jl, jp = jcs.run_mark_compact(jkhi, jpay, jcs.TRIOEVAL_MAX_RUNS,
                                  interpret=True)
    pl, pp = pcs.run_mark_compact(khi, ppay)
    np.testing.assert_array_equal(pl[:n].numpy(),
                                  np.asarray(jl)[:n].astype(np.int32))
    np.testing.assert_array_equal(pp[:n].numpy(), np.asarray(jp)[:n])
    # the host models of the typing and of the marker rule
    is_k, hflag, htyp = ptrio._types_and_flags(
        np.where(valid, vals, ptrio.NO_KMER))
    np.testing.assert_array_equal(is_k, valid)
    np.testing.assert_array_equal(flag.numpy(), hflag)
    np.testing.assert_array_equal(typ.numpy(), htyp)
    lanes, lens, typs = ptrio._host_te_markers(typ.numpy(), we, min_n)
    np.testing.assert_array_equal(pl[:n].numpy(), lanes)
    np.testing.assert_array_equal(pp[:n].numpy(), lens << 2 | typs)


def test_trioeval_psort_markers_match_jax():
    """get_trioeval_psort_mid + run_marker_psort (the Pallas sort in
    interpret mode) against the port's run_marker_sort."""
    M = 6000
    vals, valid, we = _value_stream(14, M)
    Bpad = jcs.qv_psort_pad(M)
    vpad = np.concatenate([vals, np.zeros(Bpad - M, np.int32)])
    key, payload, jn = jcs.get_trioeval_psort_mid(2, M, Bpad)(
        jnp.asarray(vpad), jnp.asarray(valid), jnp.asarray([we], np.int32))
    jk, jp = jcs.run_marker_psort(key, payload, jcs.TRIOEVAL_MAX_RUNS,
                                  interpret=True)
    _flag, typ = pcs.trio_types(torch.from_numpy(vals),
                                torch.from_numpy(valid))
    khi, ppay, n = pcs.trioeval_mark_mid(typ, we, 2, M)
    lanes, pays = pcs.run_marker_sort(khi, ppay)
    n = int(n)
    assert n == int(jn) > 100
    np.testing.assert_array_equal(lanes[:n].numpy(),
                                  np.asarray(jk)[:n].astype(np.int32))
    np.testing.assert_array_equal(pays[:n].numpy(),
                                  np.asarray(jp)[:n].astype(np.int32))


def test_inputs_reach_the_fold_branches(inputs, tables):
    """The child FASTA drives the host fold through a chunk that is one
    piece and one type-1 run end to end, and through pieces that
    continue into the next chunk."""
    seen = []
    real = ptrio._TriobinFold.chunk

    def spy(self, packed, S, scal4, d_txt, M):
        we = int(packed.rec_start[-1] + packed.rec_take[-1] - self.k)
        continues = (int(packed.rec_off0[-1] + packed.rec_take[-1])
                     < int(packed.rec_len[-1]))
        seen.append((len(packed.rec_gid), int(scal4[1]) == we + 1,
                     int(scal4[0]), continues))
        return real(self, packed, S, scal4, d_txt, M)

    ptrio._TriobinFold.chunk = spy
    try:
        _run(ptrio, "triobin", tables[1], inputs["child"])
    finally:
        ptrio._TriobinFold.chunk = real
    assert (1, True, 1, True) in seen
    assert sum(c[3] for c in seen) >= 4


def _port_text(inputs, tables, monkeypatch, cmd, opts, psort):
    """The port's text of a case on its default engine or, with
    `psort`, under YAK_TPU_PSORT=1."""
    if psort:
        monkeypatch.setenv("YAK_TPU_PSORT", "1")
    return _run(ptrio, cmd, tables[1], inputs["child"], **opts)


@pytest.mark.parametrize("psort", [False, True])
@pytest.mark.parametrize("opts", [{}, {"print_diff": True},
                                  {"ratio_thres": 0.5}])
def test_main_triobin_stdout_matches_jax(inputs, tables, monkeypatch, psort,
                                         opts):
    monkeypatch.delenv("YAK_TPU_PSORT", raising=False)
    want = _jax_text(inputs, tables, "triobin", opts)
    got = _port_text(inputs, tables, monkeypatch, "triobin", opts, psort)
    assert got == want
    rows = [r.split("\t") for r in got.splitlines() if r[0] != "D"]
    assert len(rows) == 36 and {r[1] for r in rows} == {"p", "m", "a", "0"}
    if opts.get("print_diff"):
        assert got.count("D\t") > 10000


@pytest.mark.parametrize("psort", [False, True])
@pytest.mark.parametrize("opts", [{}, {"print_err": True},
                                  {"print_frag": False}, {"min_n": 3}])
def test_main_trioeval_stdout_matches_jax(inputs, tables, monkeypatch, psort,
                                          opts):
    monkeypatch.delenv("YAK_TPU_PSORT", raising=False)
    want = _jax_text(inputs, tables, "trioeval", opts)
    got = _port_text(inputs, tables, monkeypatch, "trioeval", opts, psort)
    assert got == want
    assert got.startswith(ptrio.TRIOEVAL_HEADER)
    assert got.count("\nS\t") == 36 and "\nW\t" in got
    if opts.get("print_err"):
        assert got.count("\nE\t") > 10
    if opts.get("print_frag", True):
        assert got.count("\nF\t") > 50


@pytest.mark.parametrize("psort", [False, True])
@pytest.mark.parametrize("cmd,opts", [("triobin", {"print_diff": True}),
                                      ("trioeval", {"print_err": True})])
def test_marker_budget_overflow_matches_jax(inputs, tables, monkeypatch,
                                            psort, cmd, opts):
    """A budget of 64 markers a chunk in both packages: the JAX package
    takes the chunk's per-position values, the port copies every marker
    of its compacted (or sorted) planes; the text is the same."""
    monkeypatch.delenv("YAK_TPU_PSORT", raising=False)
    for mod in (jcs, pcs):
        monkeypatch.setattr(mod, "TRIOBIN_MAX_DIFF", 64)
        monkeypatch.setattr(mod, "TRIOEVAL_MAX_RUNS", 64)
    key = ("overflow", cmd)
    jcs.get_triobin_step.cache_clear()
    jcs.get_trioeval_step.cache_clear()
    try:
        if key not in _JAX_TEXT:
            _JAX_TEXT[key] = _run(jtrio, cmd, tables[0], inputs["child"],
                                  **opts)
        got = _port_text(inputs, tables, monkeypatch, cmd, opts, psort)
    finally:
        jcs.get_triobin_step.cache_clear()
        jcs.get_trioeval_step.cache_clear()
    assert got == _JAX_TEXT[key] == _jax_text(inputs, tables, cmd, opts)
    assert got.count("\n") > 100


@pytest.mark.parametrize("cmd", [["triobin", "-p"], ["trioeval", "-e"]])
def test_cli_matches_jax(inputs, cmd):
    args = [*cmd, f"-K{CHUNK}", inputs["pat"], inputs["mat"], inputs["child"]]
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "yak_tpu_torch",
                          "--device", "cpu", *args],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert f"[M::main] CMD: yak_tpu_torch {cmd[0]}" in res.stderr
    buf, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        assert jax_cli.main(args) == 0
    assert res.stdout == buf.getvalue()
    line = [r for r in err.getvalue().splitlines() if "[M::trioeval]" in r]
    assert line == [r for r in res.stderr.splitlines()
                    if "[M::trioeval]" in r]
    assert len(line) == (cmd[0] == "trioeval")


def test_cli_usage_and_device(inputs):
    """Too few arguments print the usage and exit 1; --device cuda
    without a card raises, as for every command."""
    for c in ("triobin", "trioeval"):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            assert cli.main([c, "--device", "cpu", inputs["pat"]]) == 1
        assert f"Usage: yak_tpu_torch {c} [options]" in err.getvalue()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["triobin", inputs["pat"], inputs["mat"],
                      inputs["child"]])
