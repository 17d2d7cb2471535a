"""The psort engine of the port on the CPU (YAK_TPU_PSORT=1: every batch
sort of count, qv and chkerr through ops/sort.sort, whose CPU version is
the plain torch sort) against the JAX package: the count table with its
overflow replay equal to `yak_tpu`'s psort engine (Pallas bitonic sort
and merge in interpret mode); `.yak` dumps at k=33 and of the -b20
two-pass equal to `yak_tpu`'s default engine's; qv -p and chkerr stdout
equal to `yak_tpu`'s psort engine's (the JOIN and the bitonic sorts in
interpret mode); the CLI.  A spy shows which sorts each engine runs.
Every value is an integer: all comparisons are exact."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_lookup_cases import CHUNK, write_contigs, write_reads
from yak_tpu.models import chkerr as jch
from yak_tpu.models import count as jcount
from yak_tpu.models import qv as jqv
from yak_tpu.table import KmerTable as JaxTable
from yak_tpu_torch.models import chkerr as pch
from yak_tpu_torch.models import count as pcount
from yak_tpu_torch.models import qv as pqv
from yak_tpu_torch.ops import countstep as pcs
from yak_tpu_torch.ops import sort as psort
from yak_tpu_torch.table import KmerTable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPH = np.frombuffer(b"ACGT", np.uint8)
READ_LEN = 127
ENGINE_VARS = ("YAK_TPU_PSORT", "YAK_TPU_ENGINE", "YAK_TPU_PSORT_BLOOM",
               "YAK_TPU_PSORT_WIDE", "YAK_TPU_PSORT_INTERPRET",
               "YAK_TPU_JOIN_INTERPRET")


@pytest.fixture
def env(monkeypatch):
    """monkeypatch with every engine variable unset first."""
    for name in ENGINE_VARS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.fixture
def sort_spy(env):
    """Records the instantiation of every ops.sort.sort call and the
    calling function of every torch.sort call."""
    calls = {"sort": [], "torch": []}
    real_sort, real_torch_sort = psort.sort, torch.sort

    def spy(keys, payload=None):
        calls["sort"].append(psort.instance(keys, payload))
        return real_sort(keys, payload)

    def torch_spy(*args, **kw):
        calls["torch"].append(sys._getframe(1).f_code.co_name)
        return real_torch_sort(*args, **kw)

    env.setattr(psort, "sort", spy)
    env.setattr(torch, "sort", torch_spy)
    return calls


@pytest.fixture(scope="module")
def read_sets(tmp_path_factory):
    """Two read sets of one genome (the -b two-pass's two files)."""
    d = tmp_path_factory.mktemp("psort_reads")
    rng = np.random.default_rng(78)
    g = rng.integers(0, 4, 6000)
    paths = []
    for name in ("a", "b"):
        paths.append(str(d / f"{name}.fq"))
        with open(paths[-1], "wb") as f:
            for i in range(700):
                s = rng.integers(0, len(g) - READ_LEN)
                r = g[s:s + READ_LEN].copy()
                r[rng.random(READ_LEN) < 0.005] = rng.integers(0, 4)
                if rng.random() < 0.5:
                    r = (3 - r)[::-1]
                f.write(b"@r%d\n%s\n+\n%s\n" % (i, ALPH[r].tobytes(),
                                                  b"I" * READ_LEN))
    return paths


@pytest.fixture(scope="module")
def lookup_inputs(tmp_path_factory):
    """The FASTQ, the FASTA and the `.yak` table that `yak_tpu` counts
    from the FASTQ (tests/torch_lookup_cases.py)."""
    d = tmp_path_factory.mktemp("psort_lookup")
    fq, fa, yak = str(d / "reads.fq"), str(d / "contigs.fa"), str(d / "t.yak")
    write_reads(fq)
    write_contigs(fa)
    jcount.count_file(fq, jcount.CountOpts(k=31, chunk_size=CHUNK)).dump(yak)
    return {"fastq": fq, "fasta": fa, "yak": yak}


@pytest.mark.parametrize("setting,gated,wide,on", [
    # count folds (yak_tpu/table.py::_pallas_mode)
    ({}, False, False, False),
    ({"YAK_TPU_PSORT": "1"}, False, False, True),
    ({"YAK_TPU_ENGINE": "psort"}, False, False, True),
    ({"YAK_TPU_PSORT": "0"}, False, False, False),
    ({"YAK_TPU_PSORT": "1"}, True, True, True),
    ({"YAK_TPU_PSORT": "1", "YAK_TPU_PSORT_BLOOM": "0"}, True, False, False),
    ({"YAK_TPU_PSORT": "1", "YAK_TPU_PSORT_BLOOM": "0"}, False, True, True),
    ({"YAK_TPU_PSORT": "1", "YAK_TPU_PSORT_WIDE": "0"}, False, True, False),
    ({"YAK_TPU_PSORT": "1", "YAK_TPU_PSORT_WIDE": "0"}, True, False, True),
    # YAK_TPU_ENGINE forces k <= 31 folds only, gated ones regardless of
    # YAK_TPU_PSORT_BLOOM; pmerge and compact override YAK_TPU_PSORT=1
    ({"YAK_TPU_ENGINE": "psort", "YAK_TPU_PSORT_BLOOM": "0"}, True, False,
     True),
    ({"YAK_TPU_ENGINE": "psort"}, False, True, False),
    ({"YAK_TPU_ENGINE": "psort"}, True, True, False),
    ({"YAK_TPU_PSORT": "1", "YAK_TPU_ENGINE": "pmerge"}, False, False, False),
    ({"YAK_TPU_PSORT": "1", "YAK_TPU_ENGINE": "compact"}, True, False, False),
    ({"YAK_TPU_PSORT": "1", "YAK_TPU_ENGINE": "pmerge"}, False, True, True),
    # xla keeps every fold off the psort engine
    ({"YAK_TPU_PSORT": "1", "YAK_TPU_ENGINE": "xla"}, False, False, False),
    ({"YAK_TPU_PSORT": "1", "YAK_TPU_ENGINE": "xla"}, False, True, False),
    # a gated k >= 32 fold keeps the psort engine under PSORT_BLOOM=0
    ({"YAK_TPU_PSORT": "1", "YAK_TPU_PSORT_BLOOM": "0"}, True, True, True),
    # qv and chkerr runs (gated None): YAK_TPU_PSORT alone
    # (yak_tpu/ops/countstep.py::psort_enabled)
    ({}, None, None, False),
    ({"YAK_TPU_PSORT": "1"}, None, None, True),
    ({"YAK_TPU_ENGINE": "psort"}, None, None, False),
    ({"YAK_TPU_PSORT": "1", "YAK_TPU_ENGINE": "pmerge"}, None, None, True),
    ({"YAK_TPU_PSORT": "1", "YAK_TPU_ENGINE": "xla"}, None, None, True),
    ({"YAK_TPU_PSORT": "1", "YAK_TPU_PSORT_BLOOM": "0",
      "YAK_TPU_PSORT_WIDE": "0"}, None, None, True),
])
def test_psort_enabled(env, setting, gated, wide, on):
    """The psort side of the engine choice: whether yak_tpu's
    table._pallas_mode (countstep.fold_engine) puts a count fold on the
    psort engine, and countstep.psort_enabled (qv and chkerr runs,
    gated None)."""
    for name, value in setting.items():
        env.setenv(name, value)
    if gated is None:
        assert pcs.psort_enabled() is on
    else:
        assert (pcs.fold_engine(33 if wide else 31, gated) == "psort") is on


def test_count_replay_matches_jax_psort(env, sort_spy):
    """The k=21 count of tests/test_table.py's psort case (3 x 8192
    bases, cap 2^14, so a fold overflows and replays): the same items as
    `yak_tpu`'s psort engine, every fold and replay sorted by the
    kernel's int64 instantiation."""
    rng = np.random.default_rng(77)
    k = 21
    chunks = [rng.integers(0, 4, size=8192).astype(np.uint8)
              for _ in range(3)]
    env.setenv("YAK_TPU_PSORT_INTERPRET", "1")
    jt = JaxTable(k, cap_log2=14, cap_hinted=True, flush_lanes=8192)
    for c in chunks:
        jt.insert_codes(c)
    href, cref = jt.items()
    assert jt.cap > (1 << 14)
    env.setenv("YAK_TPU_PSORT", "1")
    t = KmerTable(k, cap_log2=14, cap_hinted=True, flush_lanes=8192,
                  device="cpu")
    for c in chunks:
        t.insert_codes(c)
    h, cnt = t.items()
    assert t.cap > (1 << 14)          # the replay really grew
    np.testing.assert_array_equal(h, href)
    np.testing.assert_array_equal(cnt, cref)
    # two folds (chunks 1-2, chunk 3) and the replay of the second
    assert sort_spy["sort"] == ["i64"] * 3


@pytest.mark.parametrize("bf_shift", [20, 31])
def test_gated_replay_matches_jax(env, sort_spy, bf_shift):
    """tests/test_torch_bloom.py's gated overflow replay under the psort
    engine: a gated fold overflows a cap-hinted 2^14 table and replays
    on the psort engine against the pre-fold filter (-b20: the plain
    post's kept filter; -b31: its sparse tail's undo record); items and
    filter equal the JAX package's default engine's."""
    rng = np.random.default_rng(41)
    k = 21
    chunks = [c for c in (rng.integers(0, 4, size=8192).astype(np.uint8)
                          for _ in range(3)) for _ in range(2)]
    jt = JaxTable(k, cap_log2=14, cap_hinted=True, bf_shift=bf_shift,
                  flush_lanes=8192)
    env.setenv("YAK_TPU_PSORT", "1")
    t = KmerTable(k, cap_log2=14, cap_hinted=True, flush_lanes=8192,
                  device="cpu", bf_shift=bf_shift)
    for table in (jt, t):
        for c in chunks:
            table.insert_codes(c)
        table.flush()
    assert t.cap > (1 << 14)           # the replay really grew
    for a, b in zip(t.items(), jt.items()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t.bf.numpy().view(np.uint32),
                                  np.asarray(jt.bf).view(np.uint32))
    assert len(sort_spy["sort"]) > 3 and "bloom_insert" in sort_spy["torch"]


@pytest.mark.parametrize("name", ["k33", "b20_two_files"])
def test_count_dump_matches_jax(env, read_sets, tmp_path, name):
    """count -k33 and the -b20 literal two-pass under the psort engine:
    dumps byte-identical to `yak_tpu`'s default engine's."""
    if name == "k33":
        jt = jcount.count_file(read_sets[0], jcount.CountOpts(
            k=33, chunk_size=CHUNK))
        env.setenv("YAK_TPU_PSORT", "1")
        t = pcount.count_file(read_sets[0], pcount.CountOpts(
            k=33, chunk_size=CHUNK, device="cpu"))
    else:
        jt = jcount.count(read_sets, jcount.CountOpts(
            k=31, bf_shift=20, chunk_size=CHUNK))
        env.setenv("YAK_TPU_PSORT", "1")
        t = pcount.count(read_sets, pcount.CountOpts(
            k=31, bf_shift=20, chunk_size=CHUNK, device="cpu"))
    jt.dump(str(tmp_path / "jax.yak"))
    t.dump(str(tmp_path / "port.yak"))
    assert t.tot > 1000
    assert (tmp_path / "port.yak").read_bytes() == \
        (tmp_path / "jax.yak").read_bytes()


@pytest.mark.parametrize("cmd,kind", [("qv", "fastq"), ("qv", "fasta"),
                                      ("chkerr", "fastq"),
                                      ("chkerr", "fasta")])
def test_lookup_stdout_matches_jax_psort(env, lookup_inputs, cmd, kind):
    """qv -p and chkerr at chunk 16384 (sequences and low runs across
    chunk edges) under both packages' psort engines: the same stdout."""
    env.setenv("YAK_TPU_PSORT_INTERPRET", "1")
    env.setenv("YAK_TPU_JOIN_INTERPRET", "1")
    env.setenv("YAK_TPU_PSORT", "1")
    texts = []
    for mod, table in ((jqv if cmd == "qv" else jch,
                        JaxTable.restore(lookup_inputs["yak"])),
                       (pqv if cmd == "qv" else pch,
                        KmerTable.restore(lookup_inputs["yak"], "cpu"))):
        buf = io.StringIO()
        if cmd == "qv":
            mod.main_qv(mod.QvOpts(chunk_size=CHUNK, print_each=True), table,
                        lookup_inputs[kind], out=buf)
        else:
            mod.main_chkerr(mod.ChkerrOpts(chunk_size=CHUNK), table,
                            lookup_inputs[kind], out=buf)
        texts.append(buf.getvalue())
    assert texts[1] == texts[0]
    assert texts[0].count("\n") > 20


def test_cli_count_matches_jax(read_sets, tmp_path):
    """YAK_TPU_PSORT=1 python -m yak_tpu_torch count --device cpu: the
    dump of `yak_tpu`'s default engine."""
    out = str(tmp_path / "cli.yak")
    env = {k: v for k, v in os.environ.items() if k not in ENGINE_VARS}
    env.update(PYTHONPATH=ROOT, YAK_TPU_PSORT="1")
    res = subprocess.run(
        [sys.executable, "-m", "yak_tpu_torch", "count", "-k31",
         f"-K{CHUNK}", "--device", "cpu", "-o", out, read_sets[0]],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    jt = jcount.count_file(read_sets[0], jcount.CountOpts(k=31,
                                                          chunk_size=CHUNK))
    jt.dump(str(tmp_path / "jax.yak"))
    assert open(out, "rb").read() == (tmp_path / "jax.yak").read_bytes()


def _port_runs(read_sets, lookup_inputs, emit_ek=False):
    """A -b20 gated count, a k=33 count, qv and chkerr through the port;
    returns the qv/chkerr texts."""
    pcount.count(read_sets, pcount.CountOpts(k=31, bf_shift=20,
                                             chunk_size=CHUNK, device="cpu"))
    pcount.count_file(read_sets[0], pcount.CountOpts(k=33, chunk_size=CHUNK,
                                                     device="cpu"))
    table = KmerTable.restore(lookup_inputs["yak"], "cpu")
    pqv.main_qv(pqv.QvOpts(chunk_size=CHUNK, print_err_kmer=emit_ek), table,
                lookup_inputs["fasta"], out=io.StringIO())
    pch.main_chkerr(pch.ChkerrOpts(chunk_size=CHUNK), table,
                    lookup_inputs["fasta"], out=io.StringIO())


def _refuse(name):
    def fail(*_args, **_kw):
        raise AssertionError(f"{name} called under the psort engine")
    return fail


def test_psort_takes_every_batch_sort(env, sort_spy, read_sets,
                                      lookup_inputs):
    """With YAK_TPU_PSORT=1 every batch sort of count (plain, gated,
    wide), of qv without -E and of chkerr is an ops.sort.sort call, each
    instantiation is used, the marker compaction and the sentinel gate
    post are never called, and torch.sort runs only inside the plain
    sort and the gate post's filter update (bloom_insert, the JAX
    package's XLA sort inside get_bloom_gate_post), the CPU version of
    the merge kernel (merge_batch_core) and the table's shrink
    (compact_where)."""
    env.setenv("YAK_TPU_PSORT", "1")
    env.setattr(pcs, "run_mark_compact", _refuse("run_mark_compact"))
    env.setattr(pcs, "bloom_gate_sentinel_post",
                _refuse("bloom_gate_sentinel_post"))
    _port_runs(read_sets, lookup_inputs)
    assert set(sort_spy["sort"]) == set(psort.INSTANCES)
    assert set(sort_spy["torch"]) == {"sort_plain", "bloom_insert",
                                      "merge_batch_core", "compact_where"}


def test_psort_with_ek_keeps_default_post(env, sort_spy, lookup_inputs):
    """qv -E under the psort engine: the query sort through the kernel,
    the post (region keys and -E markers) the default engine's."""
    env.setenv("YAK_TPU_PSORT", "1")
    table = KmerTable.restore(lookup_inputs["yak"], "cpu")
    pqv.main_qv(pqv.QvOpts(chunk_size=CHUNK, print_err_kmer=True), table,
                lookup_inputs["fasta"], out=io.StringIO())
    assert set(sort_spy["sort"]) == {"i64_i32"}
    assert {"qv_chunk_stats", "qv_ek_markers"} <= set(sort_spy["torch"])


def test_sub_gates_send_folds_back(env, sort_spy, read_sets):
    """YAK_TPU_PSORT_WIDE=0: the k=33 folds take the default engine;
    YAK_TPU_PSORT_BLOOM=0: the gated folds of -b20's pass 1 do (the
    sentinel gate post), pass 2's ungated folds stay on psort."""
    env.setenv("YAK_TPU_PSORT", "1")
    env.setenv("YAK_TPU_PSORT_WIDE", "0")
    pcount.count_file(read_sets[0], pcount.CountOpts(k=33, chunk_size=CHUNK,
                                                     device="cpu"))
    assert sort_spy["sort"] == []
    env.setenv("YAK_TPU_PSORT_BLOOM", "0")
    pcount.count(read_sets, pcount.CountOpts(k=31, bf_shift=20,
                                             chunk_size=CHUNK, device="cpu"))
    assert set(sort_spy["sort"]) == {"i64"}
    assert {"sort_batch", "bloom_gate_sentinel_post"} <= \
        set(sort_spy["torch"])


def test_engine_var_takes_k31_folds_only(env, sort_spy, read_sets,
                                         lookup_inputs):
    """YAK_TPU_ENGINE=psort: the k <= 31 folds (the gated ones too) sort
    through the kernel; the k >= 32 folds, qv and chkerr do not, as in
    the JAX package."""
    env.setenv("YAK_TPU_ENGINE", "psort")
    env.setenv("YAK_TPU_PSORT_BLOOM", "0")
    _port_runs(read_sets, lookup_inputs)
    # -b20 over two files of 700 reads at chunk 16384: one gated fold in
    # pass 1, one fold in pass 2
    assert sort_spy["sort"] == ["i64", "i64"]
    assert {"lookup_keys", "qv_chunk_stats"} <= set(sort_spy["torch"])


def test_default_engine_never_calls_sort(env, sort_spy, read_sets,
                                         lookup_inputs):
    _port_runs(read_sets, lookup_inputs)
    assert sort_spy["sort"] == []
    assert {"sort_batch", "lookup_keys", "qv_chunk_stats",
            "bloom_gate_sentinel_post"} <= set(sort_spy["torch"])
