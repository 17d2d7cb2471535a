"""The count engines and knobs of the port on the CPU against the JAX
package: the engine choice of `countstep.fold_engine` (yak_tpu's
table._pallas_mode), `sorttable.merge_stream` against
`merge_batch_impl(compact=False)` wherever the merged stream is defined,
the compact engine's close-up (`compact_plain` + `finalize_compacted`)
against `merge_batch`'s table, `sorttable.dedup` with the gate
(`countstep.gate_batch`) against `_gate_batch`, cheap and serial-exact,
and `.yak` dumps md5-equal to `yak_tpu`'s under YAK_TPU_ENGINE=compact
and xla, YAK_TPU_WIDE=0, YAK_TPU_BLOOM_SENTINEL=0 and YAK_TPU_PALLAS=0
(on one device and on a forced mesh), from a 2^10-lane table so the
overflow replays run.  YAK_TPU_PROFILE writes a trace.  Every value is
an integer: all comparisons are exact."""

import contextlib
import functools
import hashlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_lookup_cases import CHUNK, write_reads
from yak_tpu import cli as jax_cli
from yak_tpu.models import count as jcount
from yak_tpu.ops import countstep as jcs
from yak_tpu.ops import sorttable as jst
from yak_tpu.ops.bloom import make_bloom as jmake_bloom
from yak_tpu_torch import cli
from yak_tpu_torch.models import count as pcount
from yak_tpu_torch.ops import countstep as pcs
from yak_tpu_torch.ops import sorttable
from yak_tpu_torch.ops.compact import compact_plain
from yak_tpu_torch.ops.keys import (INT64_MAX, decode_wide, encode_wide,
                                    torch_to_u64, u64_to_torch)
from yak_tpu_torch.table import KmerTable

KNOBS = ("YAK_TPU_PSORT", "YAK_TPU_ENGINE", "YAK_TPU_PSORT_BLOOM",
         "YAK_TPU_PSORT_WIDE", "YAK_TPU_WIDE", "YAK_TPU_PALLAS",
         "YAK_TPU_JOIN", "YAK_TPU_MARK_COMPACT", "YAK_TPU_BLOOM_SENTINEL",
         "YAK_TPU_QV_SEG", "YAK_TPU_BLOOM_TWO_PASS", "YAK_TPU_MESH",
         "YAK_TPU_PROFILE", "YAK_TPU_EXACT_DUMP")


@pytest.fixture
def env(monkeypatch):
    """monkeypatch with every engine variable unset first."""
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize("setting,k,gated,exact,engine", [
    ({}, 31, False, False, "pmerge"),
    ({}, 31, True, False, "pmerge"),
    ({}, 31, True, True, "pmerge"),
    ({}, 33, False, False, "pmerge"),
    ({}, 33, True, True, "xla"),         # -X -b at k >= 32: the sort-merge
    ({"YAK_TPU_ENGINE": "compact"}, 31, False, False, "compact"),
    ({"YAK_TPU_ENGINE": "compact"}, 31, True, True, "compact"),
    ({"YAK_TPU_ENGINE": "compact"}, 33, False, False, "pmerge"),
    ({"YAK_TPU_ENGINE": "xla"}, 17, True, False, "xla"),
    ({"YAK_TPU_ENGINE": "xla"}, 33, False, False, "xla"),
    ({"YAK_TPU_ENGINE": "pmerge", "YAK_TPU_PSORT": "1"}, 31, False, False,
     "pmerge"),
    ({"YAK_TPU_ENGINE": "bogus"}, 31, False, False, "pmerge"),   # = auto
    ({"YAK_TPU_ENGINE": "bogus", "YAK_TPU_PSORT": "1"}, 31, False, False,
     "psort"),
    ({"YAK_TPU_WIDE": "0"}, 33, False, False, "xla"),
    ({"YAK_TPU_WIDE": "0"}, 31, False, False, "pmerge"),
    ({"YAK_TPU_WIDE": "0", "YAK_TPU_PSORT": "1"}, 33, False, False,
     "psort"),
    ({"YAK_TPU_WIDE": "0", "YAK_TPU_PSORT": "1",
      "YAK_TPU_PSORT_WIDE": "0"}, 33, True, False, "xla"),
    ({"YAK_TPU_PALLAS": "0"}, 31, False, False, "xla"),
    ({"YAK_TPU_PALLAS": "false"}, 33, True, False, "xla"),
    ({"YAK_TPU_PALLAS": "no", "YAK_TPU_ENGINE": "compact"}, 31, True, True,
     "xla"),
    ({"YAK_TPU_PALLAS": "1"}, 31, False, False, "pmerge"),
    ({"YAK_TPU_PSORT": "1"}, 31, True, True, RuntimeError),
    ({"YAK_TPU_ENGINE": "psort"}, 33, True, True, RuntimeError),
    ({"YAK_TPU_PSORT": "1", "YAK_TPU_ENGINE": "xla"}, 31, True, True,
     RuntimeError),
    ({"YAK_TPU_PSORT": "1"}, 31, True, False, "psort"),
    ({"YAK_TPU_PSORT": "1", "YAK_TPU_PALLAS": "0"}, 31, False, False, "xla"),
])
def test_fold_engine(env, setting, k, gated, exact, engine):
    """The port of yak_tpu/table.py::_pallas_mode with its precedence."""
    for name, value in setting.items():
        env.setenv(name, value)
    if engine is RuntimeError:
        with pytest.raises(RuntimeError, match="serial-exact"):
            pcs.fold_engine(k, gated, exact)
    else:
        assert pcs.fold_engine(k, gated, exact) == engine


@pytest.mark.parametrize("setting,join,mark,psort", [
    ({}, True, True, False),
    ({"YAK_TPU_JOIN": "0"}, False, False, False),
    ({"YAK_TPU_PALLAS": "0"}, False, False, False),
    ({"YAK_TPU_MARK_COMPACT": "0"}, True, False, False),
    ({"YAK_TPU_PSORT": "1"}, True, True, True),
    ({"YAK_TPU_PSORT": "1", "YAK_TPU_JOIN": "0"}, False, False, False),
])
def test_lookup_switches(env, setting, join, mark, psort):
    """join_enabled (countstep.join_enabled, without its k), the marker
    compaction's switch, and the lookups' psort, which the JAX package
    takes only under its JOIN."""
    for name, value in setting.items():
        env.setenv(name, value)
    assert pcs.join_enabled() is join
    assert pcs.mark_compact_enabled() is mark
    assert pcs.psort_enabled() is psort


# -- merge_stream and the compact engine's close-up ----------------------

def _merge_case(seed, k, cap, n, B, fresh):
    """A table of n unique ascending k-bit hashes in cap lanes (garbage
    beyond n) and a batch of B hashes, `fresh` of them new, the rest
    drawn from the table, with a tenth invalid."""
    rng = np.random.default_rng(seed)
    top = 1 << (2 * k)
    keys = np.unique(rng.integers(0, top, n + B, dtype=np.uint64))
    rng.shuffle(keys)
    tk = np.sort(keys[:n])
    table = np.full(cap, 0xDEADBEEF, np.uint64)
    table[:n] = tk
    tc = rng.integers(1, 1024, cap).astype(np.int32)
    pool = keys[n:n + fresh] if fresh else tk[:1]
    pick = rng.random(B) < (fresh / max(B, 1))
    batch = np.where(pick, rng.choice(pool, B) if B else pool[:0],
                     rng.choice(tk, B) if B else tk[:0]).astype(np.uint64)
    valid = rng.random(B) > 0.1
    return table, tc, n, batch, valid


MERGE_CASES = {
    "k31-create": (1, 31, 512, 300, 900, 200, True),
    "k31-increment": (2, 31, 512, 300, 900, 200, False),
    "k17-create": (3, 17, 256, 100, 700, 120, True),
    "k31-empty-batch": (4, 31, 64, 40, 0, 0, True),
    "k31-overflow": (5, 31, 128, 100, 600, 400, True),
    "k17-increment-big-batch": (6, 17, 64, 60, 500, 300, False),
}


def _jax_stream(table, tc, n, batch, valid, create):
    fn = jax.jit(functools.partial(jst.merge_batch_impl, mode=jst.ADD,
                                   create=create, packable=True,
                                   compact=False))
    out = fn(jnp.asarray(table), jnp.asarray(tc), jnp.int32(n),
             jnp.asarray(batch), jnp.ones(len(batch), jnp.int32),
             jnp.asarray(valid))
    return [np.asarray(o) for o in out]


def _port_args(table, tc, n, batch, valid):
    return (u64_to_torch(table), torch.from_numpy(tc),
            torch.tensor(n, dtype=torch.int32), u64_to_torch(batch),
            torch.ones(len(batch), dtype=torch.int32),
            torch.from_numpy(valid))


@pytest.mark.parametrize("name", MERGE_CASES)
def test_merge_stream_matches_jax(name):
    """Lane for lane where the contract defines the stream: every real
    lane's key (the live table and the valid batch, sorted), which lanes
    are kept (khi < 0 marks the rest), the count at kept lanes, the
    clamped size, n_new and the overflow flag.  Counts at dropped lanes
    and the keys of pad lanes are not defined."""
    seed, k, cap, n, B, fresh, create = MERGE_CASES[name]
    case = _merge_case(seed, k, cap, n, B, fresh)
    jhi, jlo, jv, jsize, jnew, jovf = _jax_stream(*case, create)
    phi, plo, pv, psize, pnew, povf = sorttable.merge_stream(
        *_port_args(*case), create)
    assert phi.dtype == plo.dtype == pv.dtype == torch.int32
    assert phi.shape[0] == cap + B
    n_real = n + int(case[4].sum())
    jkey = ((jhi.astype(np.uint64) << np.uint64(32))
            | jlo.astype(np.uint64)) & np.uint64((1 << 63) - 1)
    pkey = torch_to_u64((phi.to(torch.int64) << 32)
                        | (plo.to(torch.int64) & 0xFFFFFFFF)) \
        & np.uint64((1 << 63) - 1)
    np.testing.assert_array_equal(pkey[:n_real], jkey[:n_real])
    jkeep = (jhi & 0x80000000) == 0
    pkeep = phi.numpy() >= 0
    np.testing.assert_array_equal(pkeep, jkeep)
    np.testing.assert_array_equal(pv.numpy()[pkeep], jv[jkeep])
    assert (int(psize), int(pnew), bool(povf)) == (int(jsize), int(jnew),
                                                   bool(jovf))
    assert bool(povf) == name.endswith("overflow")


@pytest.mark.parametrize("name", MERGE_CASES)
def test_compact_engine_table_matches_jax(name):
    """merge_stream closed up by the compaction's plain version and
    finalize_compacted: the first min(new_size, cap) lanes are
    merge_batch's table (the JAX package's compact engine and its xla
    engine give the same)."""
    seed, k, cap, n, B, fresh, create = MERGE_CASES[name]
    case = _merge_case(seed, k, cap, n, B, fresh)
    table, tc, n, batch, valid = case
    jk, jc, jsize, jnew, jovf = jst.merge_batch(
        jnp.asarray(table), jnp.asarray(tc), jnp.int32(n),
        jnp.asarray(batch), jnp.ones(len(batch), jnp.int32),
        jnp.asarray(valid), mode=jst.ADD, create=create, packable=True)
    khi, klo, v, size, n_new, ovf = sorttable.merge_stream(
        *_port_args(*case), create)
    keys, cnt = pcs.finalize_compacted(*compact_plain(khi, klo, v)[:3], cap)
    live = int(jsize)
    assert int(size) == live and bool(ovf) == bool(jovf)
    np.testing.assert_array_equal(torch_to_u64(keys)[:live],
                                  np.asarray(jk)[:live])
    np.testing.assert_array_equal(cnt.numpy()[:live], np.asarray(jc)[:live])
    # and the xla engine's merge_batch, whose core the merge kernel's
    # plain version is, agrees
    xk, xc, xsize, xnew, xovf = sorttable.merge_batch(
        *_port_args(*case), create)
    np.testing.assert_array_equal(torch_to_u64(xk)[:live],
                                  np.asarray(jk)[:live])
    np.testing.assert_array_equal(xc.numpy()[:live], np.asarray(jc)[:live])
    assert int(xnew) == int(n_new) == int(jnew)


# -- dedup and the gate ---------------------------------------------------

GATE_CASES = {
    "cheap-k31": (11, False, False),
    "exact-k31": (12, True, False),
    "cheap-wide": (13, False, True),
    "exact-wide": (14, True, True),
}


@pytest.mark.parametrize("name", GATE_CASES)
def test_gate_batch_matches_jax(name):
    """sorttable.dedup and countstep.gate_batch against
    sorttable.dedup and _gate_batch on a batch with repeats and invalid
    lanes, a filter of 2^20 bits half full so gates pass and fail and
    (exact) keys of one batch set each other's bits: the sorted valid
    keys, the run starts, the weights at the starts, the filter."""
    seed, exact, wide = GATE_CASES[name]
    rng = np.random.default_rng(seed)
    pre, bf_shift, nh, B = 10, 20, 4, 6000
    if wide:
        pool = rng.integers(0, 1 << 64, 2500, dtype=np.uint64)
    else:
        pool = rng.integers(0, 1 << 62, 2500, dtype=np.uint64)
    h = rng.choice(pool, B)
    valid = rng.random(B) > 0.05
    bf0 = np.asarray(jmake_bloom(bf_shift)).copy()
    bf0 |= rng.integers(0, 1 << 32, bf0.shape, dtype=np.uint64).astype(
        bf0.dtype) & rng.integers(0, 1 << 32, bf0.shape,
                                  dtype=np.uint64).astype(bf0.dtype)
    js, jstarts, jadd, jbf = jcs._gate_batch(
        jnp.asarray(h), jnp.asarray(valid), jnp.asarray(bf0), pre,
        bf_shift, nh, exact, packable=not wide)
    raw = u64_to_torch(h)
    keys = torch.where(torch.from_numpy(valid),
                       encode_wide(raw) if wide else raw, INT64_MAX)
    bf = torch.from_numpy(bf0.view(np.int32).copy())
    hs, starts, add, bf2, _undo = pcs.gate_batch(keys, bf, pre, bf_shift, nh,
                                                 exact, wide=wide)
    nv = int(valid.sum())
    got = decode_wide(hs) if wide else hs
    np.testing.assert_array_equal(torch_to_u64(got)[:nv], np.asarray(js)[:nv])
    assert (hs[nv:] == INT64_MAX).all()
    st_ = starts.numpy()
    np.testing.assert_array_equal(st_, np.asarray(jstarts))
    np.testing.assert_array_equal(add.numpy()[st_], np.asarray(jadd)[st_])
    np.testing.assert_array_equal(bf2.numpy().view(np.uint32),
                                  np.asarray(jbf).view(np.uint32))
    a = add.numpy()[st_]
    assert (a == 0).any() and (a > 0).any()


def test_dedup_rank_is_the_least_of_its_run():
    """dedup(rank=): each run's rank is the least of its lanes' ranks,
    whatever their order (a mesh shard's routed batch), as the JAX
    package's second sort key gives it."""
    rng = np.random.default_rng(15)
    keys = torch.from_numpy(rng.integers(0, 50, 400))
    rank = torch.from_numpy(rng.permutation(400))
    hs, starts, mult, rk = sorttable.dedup(keys, rank, with_rank=True)
    jh, jstarts, jmult, jrk = jst.dedup(
        jnp.asarray(keys.numpy().astype(np.uint64)), jnp.ones(400, bool),
        rank=jnp.asarray(rank.numpy().astype(np.int32)))
    s = starts.numpy()
    np.testing.assert_array_equal(s, np.asarray(jstarts))
    np.testing.assert_array_equal(mult.numpy()[s], np.asarray(jmult)[s])
    np.testing.assert_array_equal(rk.numpy()[s], np.asarray(jrk)[s])


# -- whole counts --------------------------------------------------------

@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_engines")
    fq = str(d / "reads.fq")
    write_reads(fq, seed=31, n=500)
    return d, fq


def _md5(path):
    return hashlib.md5(open(path, "rb").read()).hexdigest()


COUNTS = {   # name: (k, bf_shift, exact)
    "k17": (17, 0, False),
    "k31": (31, 0, False),
    "k33": (33, 0, False),
    "k31-b20": (31, 20, False),
    "k31-X-b20": (31, 20, True),
}


@pytest.fixture(scope="module")
def jax_md5(reads):
    """md5 of yak_tpu's dump for each configuration, one run each, on
    demand (-X through the CLI, the rest through count/count_file)."""
    d, fq = reads
    cache = {}

    def get(name):
        if name not in cache:
            k, bf, exact = COUNTS[name]
            out = str(d / f"jax-{name}.yak")
            with contextlib.redirect_stderr(io.StringIO()):
                if exact:
                    assert jax_cli.main(["count", "-X", f"-k{k}", f"-b{bf}",
                                         f"-K{CHUNK}", "-o", out, fq,
                                         fq]) == 0
                else:
                    opt = jcount.CountOpts(k=k, bf_shift=bf,
                                           chunk_size=CHUNK)
                    t = (jcount.count([fq, fq], opt) if bf
                         else jcount.count_file(fq, opt))
                    t.dump(out)
            cache[name] = _md5(out)
        return cache[name]
    return get


RUNS = [   # (count, knobs)
    ("k17", {"YAK_TPU_ENGINE": "compact"}),
    ("k17", {"YAK_TPU_ENGINE": "xla"}),
    ("k31", {"YAK_TPU_ENGINE": "compact"}),
    ("k31", {"YAK_TPU_ENGINE": "xla"}),
    ("k31", {"YAK_TPU_PALLAS": "0"}),
    ("k31-b20", {"YAK_TPU_ENGINE": "compact"}),
    ("k31-b20", {"YAK_TPU_ENGINE": "xla"}),
    ("k31-b20", {"YAK_TPU_ENGINE": "compact", "YAK_TPU_BLOOM_TWO_PASS": "1"}),
    ("k31-b20", {"YAK_TPU_ENGINE": "xla", "YAK_TPU_BLOOM_TWO_PASS": "1"}),
    ("k31-b20", {"YAK_TPU_BLOOM_TWO_PASS": "1"}),
    ("k31-b20", {"YAK_TPU_BLOOM_SENTINEL": "0",
                 "YAK_TPU_BLOOM_TWO_PASS": "1"}),
    ("k31-b20", {"YAK_TPU_PALLAS": "0", "YAK_TPU_BLOOM_TWO_PASS": "1"}),
    ("k31-X-b20", {"YAK_TPU_ENGINE": "compact"}),
    ("k31-X-b20", {"YAK_TPU_ENGINE": "xla"}),
    ("k33", {"YAK_TPU_WIDE": "0"}),
    ("k33", {"YAK_TPU_ENGINE": "xla"}),
    ("k31", {"YAK_TPU_MESH": "1", "YAK_TPU_PALLAS": "0"}),
    ("k31-b20", {"YAK_TPU_MESH": "1", "YAK_TPU_PALLAS": "0",
                 "YAK_TPU_BLOOM_TWO_PASS": "1"}),
]


@pytest.mark.parametrize("name,knobs", RUNS,
                         ids=[f"{n}-" + "-".join(f"{k[8:]}={v}" for k, v
                                                 in kn.items())
                              for n, kn in RUNS])
def test_count_dump_matches_jax(reads, jax_md5, env, tmp_path, name, knobs):
    """The dump's md5 equals yak_tpu's under each knob; on one device
    from a 2^10-lane table that the replays grow (the capacity prior
    off), the folds on the engine the knobs name; under YAK_TPU_MESH=1
    through the CLI on 4 CPU shards; -X through the CLI."""
    d, fq = reads
    k, bf, exact = COUNTS[name]
    for key, value in knobs.items():
        env.setenv(key, value)
    engines = []
    real = pcs.count_step

    def spy(*args, engine="pmerge", **kw):
        engines.append(engine)
        return real(*args, engine=engine, **kw)

    env.setattr(pcs, "count_step", spy)
    sentinel = []
    real_post = pcs.bloom_gate_sentinel_post
    env.setattr(pcs, "bloom_gate_sentinel_post",
                lambda *a, **kw: sentinel.append(1) or real_post(*a, **kw))
    out = str(tmp_path / "p.yak")
    if exact or "YAK_TPU_MESH" in knobs:
        flags = [f"-k{k}"] + ([f"-b{bf}"] if bf else []) + (
            ["-X"] if exact else [])
        with contextlib.redirect_stderr(io.StringIO()):
            assert cli.main(["count", *flags, f"-K{CHUNK}", "--device",
                             "cpu", "-o", out, fq] + ([fq] if bf else [])) == 0
    else:
        env.setattr(pcount, "KmerTable", functools.partial(
            KmerTable, cap_hinted=True))
        opt = pcount.CountOpts(k=k, bf_shift=bf, chunk_size=CHUNK,
                               cap_log2=10, device="cpu")
        with contextlib.redirect_stderr(io.StringIO()):
            t = pcount.count([fq, fq], opt) if bf else pcount.count_file(
                fq, opt)
        assert t.cap > 1 << 10
        t.dump(out)
    assert _md5(out) == jax_md5(name)
    want = pcs.fold_engine(k, bf > 0, exact)
    assert engines and set(engines) <= {want, pcs.fold_engine(k)}
    assert want in engines
    # the sentinel gate post serves the default engine's gated folds,
    # unless YAK_TPU_BLOOM_SENTINEL=0
    gated = bf and not exact and "YAK_TPU_BLOOM_TWO_PASS" in knobs
    assert bool(sentinel) == bool(
        gated and want == "pmerge"
        and knobs.get("YAK_TPU_BLOOM_SENTINEL") != "0")


def test_compact_engine_launches_the_compaction(reads, env, monkeypatch):
    """Under YAK_TPU_ENGINE=compact every fold's merged stream goes
    through `compact.compact` (which on a CUDA tensor launches the
    kernel or raises), once a fold, replays included."""
    d, fq = reads
    env.setenv("YAK_TPU_ENGINE", "compact")
    calls = []
    real = pcs.compact.compact
    monkeypatch.setattr(pcs.compact, "compact",
                        lambda *a: calls.append(a[0].numel()) or real(*a))
    folds = []
    real_step = pcs.sortmerge_step
    monkeypatch.setattr(pcs, "sortmerge_step",
                        lambda *a, **kw: folds.append(1) or real_step(*a,
                                                                      **kw))
    env.setattr(pcount, "KmerTable", functools.partial(KmerTable,
                                                       cap_hinted=True))
    opt = pcount.CountOpts(k=31, chunk_size=CHUNK, cap_log2=10, device="cpu")
    with contextlib.redirect_stderr(io.StringIO()):
        pcount.count_file(fq, opt)
    assert len(calls) == len(folds) > 1


def test_profile_writes_a_trace(reads, env, tmp_path):
    """YAK_TPU_PROFILE=<dir>: the command's torch.profiler trace is a
    Chrome trace in <dir>, announced on stderr."""
    d, fq = reads
    prof = tmp_path / "prof"
    env.setenv("YAK_TPU_PROFILE", str(prof))
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.main(["count", "-k21", f"-K{CHUNK}", "--device", "cpu",
                         "-o", str(tmp_path / "o.yak"), fq]) == 0
    traces = list(prof.glob("trace-*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
    assert '"traceEvents"' in traces[0].read_text()
    assert f"profiler trace written to {prof}" in err.getvalue()
