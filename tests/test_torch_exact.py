"""`count -X` in the port against the JAX package on the CPU: the
serial-exact Bloom gate (`ops/bloom.serial_count`, the rank branch of
`bloom_insert`, and `countstep.bloom_gate_exact_post`), the gated raw
hash batches (`KmerTable.insert_hashes` through a live filter), and the
byte-exact dump (`io/exactdump.py` over the port's own khashl simulator).

The gate is held three ways: against `yak_tpu.ops.bloom.bloom_insert(
rank=)` on n_before and the filter, against a serial Python loop of
yak_bf_insert (this file's copy of the one in tests/test_bloom_unit.py),
and by `exact_gate_fits` / `_warn_exact_gate` at the -b37 refusal.  The
dumps must be byte-equal to `python -m yak_tpu count -X` (run in this
process, once a configuration) for a plain k=17 count, the -b two-pass
over two distinct files whose first is a gzip FASTQ, k=33 with -b, and
YAK_TPU_EXACT_DUMP=1; and again from a table folded over several folds
with pad chunks and an overflow replay.  The cheap gate must fail the
cross-check on the two-file -b input (so that input exercises the
ranks), a tampered table must fail it, and psort with -X must be
refused."""

import contextlib
import functools
import gzip
import io
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import util
from yak_tpu import cli as jax_cli
from yak_tpu.ops.bloom import bloom_insert as jax_bloom_insert
from yak_tpu.ops.bloom import exact_gate_fits as jax_exact_gate_fits
from yak_tpu.ops.bloom import make_bloom as jax_make_bloom
from yak_tpu.table import KmerTable as JaxTable
from yak_tpu_torch import YAK_BLK_SHIFT, cli
from yak_tpu_torch.io import yakfmt
from yak_tpu_torch.io.chunks import ChunkSource
from yak_tpu_torch.io.exactdump import dump_yak_exact
from yak_tpu_torch.models import count as pcount
from yak_tpu_torch.ops import bloom
from yak_tpu_torch.ops.keys import u64_to_torch
from yak_tpu_torch.table import KmerTable

PRE = 10
CHUNK = 16384            # -K: the smallest device chunk, one fold a file
BLK = (1 << YAK_BLK_SHIFT) - 1


def _ref_insert(bits, h, pre, n_shift, n_hashes):
    """yak_bf_insert (bbf.c:25-42) of one key into the bit array `bits`:
    how many of its probed bits were already set."""
    ns_ = n_shift - pre
    xbits = ns_ - YAK_BLK_SHIFT
    x = h >> pre
    h1 = (x >> xbits) & BLK
    h2 = (x >> ns_) & BLK
    if (h2 & 31) == 0:
        h2 = (h2 + 1) & BLK
    base = ((h & ((1 << pre) - 1)) << ns_) | ((x & ((1 << xbits) - 1))
                                              << YAK_BLK_SHIFT)
    cnt, z = 0, h1
    for _ in range(n_hashes):
        if bits[base + z]:
            cnt += 1
        else:
            bits[base + z] = True
        z = (z + h2) & BLK
    return cnt


def _bits(bf):
    w = bf.numpy().view(np.uint32) if isinstance(bf, torch.Tensor) \
        else np.asarray(bf)
    return ((w[:, None] >> np.arange(32)[None, :]) & 1).astype(bool) \
        .reshape(-1)


@pytest.mark.parametrize("n_shift,n_hashes,wide", [
    (19, 4, False), (20, 3, False), (20, 4, True), (22, 8, False)])
def test_serial_gate_matches_jax_and_serial_loop(n_shift, n_hashes, wide):
    """Unique keys in an arbitrary serial order (a permutation as their
    ranks), into filters of 2^9 to 2^12 bits a shard, where keys
    collide, twice in a row: n_before and the filter equal yak_tpu's
    rank branch and the serial loop over the keys in rank order.  (The
    filter update after n_before is the cheap gate's, held in
    tests/test_torch_bloom.py on both of its tails.)"""
    rng = np.random.default_rng(n_shift * 10 + n_hashes + wide)
    top = 1 << 64 if wide else 1 << 62
    bf = bloom.make_bloom(n_shift, "cpu")
    jbf = jax_make_bloom(n_shift)
    bits = np.zeros(1 << n_shift, bool)
    for _step in range(2):
        h = np.unique(rng.integers(0, top, 1500, dtype=np.uint64))
        n = len(h)
        active = rng.random(n) < 0.9
        rank = rng.permutation(n).astype(np.int32)
        bf, n_before, _undo = bloom.bloom_insert(
            bf, u64_to_torch(h), torch.from_numpy(active),
            torch.from_numpy(rank), pre=PRE, n_shift=n_shift,
            n_hashes=n_hashes, rank_bound=n)
        jbf, jn = jax_bloom_insert(
            jbf, jnp.asarray(h), jnp.asarray(active), jnp.asarray(rank),
            pre=PRE, n_shift=n_shift, n_hashes=n_hashes, rank_bound=n)
        np.testing.assert_array_equal(n_before.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(_bits(bf), _bits(jbf))
        # the serial loop: keys inserted one by one in rank order
        want = np.zeros(n, np.int64)
        for i in np.argsort(rank):
            if active[i]:
                want[i] = _ref_insert(bits, int(h[i]), PRE, n_shift,
                                      n_hashes)
        np.testing.assert_array_equal(n_before.numpy(), want)
        np.testing.assert_array_equal(_bits(bf), bits)
        if _step == 0:   # the empty start state alone answers otherwise
            base, zs = bloom.probe_geom(u64_to_torch(h), pre=PRE,
                                        n_shift=n_shift, n_hashes=n_hashes)
            cheap = bloom.probe_count(bloom.make_bloom(n_shift, "cpu"),
                                      base, zs, torch.from_numpy(active))
            crossed = int((cheap != n_before).sum())
    assert crossed > 0


@pytest.mark.parametrize("b", [20, 24, 30, 37])
def test_exact_gate_refusal_matches_jax(b):
    """exact_gate_fits and the table's refusal of a fold (the bound
    2 * lanes + 4096) agree with yak_tpu's at the fold sizes of -K 2^23
    (two chunks a fold) and of small folds: -b37 with a fold of 2^23 or
    more lanes is refused with yak_tpu's message."""
    for lanes in (16368, 1 << 20, (1 << 22) - 2049, 1 << 23,
                  2 * ((1 << 23) - 30)):
        for n_hashes in (4, 8, 9):
            assert bloom.exact_gate_fits(b, n_hashes, 2 * lanes + 4096) == \
                jax_exact_gate_fits(b, n_hashes, 2 * lanes + 4096)
        ns = types.SimpleNamespace(bf_shift=b, bf_n_hash=4)
        msgs = []
        for cls in (KmerTable, JaxTable):
            try:
                cls._warn_exact_gate(ns, lanes)
                msgs.append(None)
            except ValueError as e:
                msgs.append(str(e))
        assert msgs[0] == msgs[1]
        if b == 37 and lanes >= 1 << 23:
            assert msgs[0] and "cannot engage" in msgs[0]


@pytest.mark.parametrize("k", [31, 33])
@pytest.mark.parametrize("exact", [False, True])
def test_gated_insert_hashes_matches_jax(k, exact):
    """Raw hash batches with duplicates and invalid lanes through a live
    filter (-b20), under both gates, three batches and a flush between:
    the items and the filter equal yak_tpu's insert_hashes.  The keys
    fall in 8 of the 1024 shards, so that keys of one batch collide."""
    rng = np.random.default_rng(k + exact)
    top = 1 << 54 if k > 31 else 1 << 52
    space = ((rng.integers(0, top, 4000, dtype=np.uint64) << np.uint64(10))
             | rng.integers(0, 8, 4000, dtype=np.uint64))
    t = KmerTable(k, PRE, device="cpu", bf_shift=20, bf_exact=exact)
    j = JaxTable(k, PRE, bf_shift=20, bf_exact=exact)
    for step in range(3):
        h = rng.choice(space, 3000)
        valid = rng.random(len(h)) < 0.95
        t.insert_hashes(u64_to_torch(h), torch.from_numpy(valid))
        j.insert_hashes(jnp.asarray(h), jnp.asarray(valid))
        if step == 1:
            t.flush()
            j.flush()
    for a, b in zip(t.items(), j.items()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_bits(t.bf), _bits(j.bf))
    assert 0 < t.tot < len(space)


def test_gated_insert_hashes_serial_order():
    """One batch whose keys collide in a tiny filter (4 shards of 2^9
    bits): the serial-exact gate admits what the serial loop over the
    batch admits."""
    rng = np.random.default_rng(5)
    h = ((rng.integers(0, 1 << 40, 2000, dtype=np.uint64) << np.uint64(10))
         | rng.integers(0, 4, 2000, dtype=np.uint64))
    h[::7] = h[1::7][:len(h[::7])]              # repeats
    t = KmerTable(31, PRE, device="cpu", bf_shift=19, bf_exact=True)
    t.insert_hashes(u64_to_torch(h), torch.ones(len(h), dtype=torch.bool))
    bits = np.zeros(1 << 19, bool)
    cnt = {}
    for x in h.tolist():
        if x in cnt:
            cnt[x] += 1
        elif _ref_insert(bits, x, PRE, 19, 4) == 4:
            cnt[x] = 1
        else:
            cnt[x] = 0
    keys = np.array(sorted(x for x, c in cnt.items() if c), np.uint64)
    got_h, got_c = t.items()
    np.testing.assert_array_equal(got_h, keys)
    np.testing.assert_array_equal(got_c, [cnt[x] for x in keys.tolist()])


# -- the -X dumps -----------------------------------------------------------

@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """A FASTA of error- and N-bearing reads in 61-base lines with two
    records shorter than k (the 3-plane layout), and a gzip FASTQ of
    other reads of the same genome, 127 bases without N (128 cells a
    read divide the 16384-cell chunk: the periodic layout), seven
    chunks of it."""
    d = tmp_path_factory.mktemp("torch_exact")
    rng = np.random.default_rng(77)
    genome = util.make_genome(rng, 20000)
    fa_reads = list(util.mutate_reads(rng, genome, 700, 110, err=0.01,
                                      n_rate=0.01))
    fa_reads += [fa_reads[0][:9], fa_reads[1][:31]]
    fa = str(d / "reads.fa")
    util.to_fasta(fa, fa_reads, line_len=61)
    fq = str(d / "reads2.fq.gz")
    util.to_fastq(str(d / "reads2.fq"),
                  util.mutate_reads(rng, genome, 800, 127, err=0.02))
    with open(str(d / "reads2.fq"), "rb") as f, gzip.open(fq, "wb") as g:
        g.write(f.read())
    return d, fa, fq


CONFIGS = {
    "plain-k17": (["-k17"], ("fa",), False),
    "b19-gzfq-then-fa": (["-k19", "-b19"], ("fq", "fa"), False),
    "b20-k33": (["-k33", "-b20"], ("fa", "fq"), False),
    "env-k19": (["-k19"], ("fq",), True),
}


def _run(main, args, env, monkeypatch):
    with monkeypatch.context() as m:
        if env:
            m.setenv("YAK_TPU_EXACT_DUMP", "1")
        with contextlib.redirect_stderr(io.StringIO()):
            assert main(args) == 0


@pytest.fixture(scope="module")
def jax_dumps(reads):
    """yak_tpu's -X dump bytes, one run a configuration, on demand."""
    d, fa, fq = reads
    files = {"fa": fa, "fq": fq}
    cache = {}

    def get(name):
        if name not in cache:
            opts, which, env = CONFIGS[name]
            out = str(d / f"jax-{name}.yak")
            args = ["count", *opts, f"-K{CHUNK}", "-o", out,
                    *(files[w] for w in which)]
            with pytest.MonkeyPatch.context() as mp:
                _run(jax_cli.main, args if env else args[:1] + ["-X"]
                     + args[1:], env, mp)
            cache[name] = open(out, "rb").read()
        return cache[name]
    return get


@pytest.mark.parametrize("name", CONFIGS)
def test_cli_exact_dump_matches_jax(reads, jax_dumps, name, monkeypatch,
                                    tmp_path):
    d, fa, fq = reads
    opts, which, env = CONFIGS[name]
    files = {"fa": fa, "fq": fq}
    out = str(tmp_path / "p.yak")
    args = ["count", *opts, f"-K{CHUNK}", "--device", "cpu", "-o", out,
            *(files[w] for w in which)]
    _run(cli.main, args if env else args[:1] + ["-X"] + args[1:], env,
         monkeypatch)
    assert open(out, "rb").read() == jax_dumps(name)


def test_exact_across_folds_and_replay(reads, jax_dumps, monkeypatch,
                                       tmp_path):
    """The two-file -b19 count folded four chunks a fold (pass 1's seven
    periodic chunks as a group of 4 and one of 3 padded with an all-N
    chunk) from a 2^12-lane table that must grow by replays, the gated
    ones through the filter's undo record: the ranks run across folds
    and pad chunks as the serial order does, so the dump is yak_tpu's
    bytes."""
    d, fa, fq = reads
    folds = []
    real = KmerTable._queue_fold

    def spy(self, carg, lanes, gated):
        folds.append((gated, carg[0]))
        return real(self, carg, lanes, gated)

    monkeypatch.setattr(KmerTable, "_queue_fold", spy)
    monkeypatch.setattr(pcount, "KmerTable", functools.partial(
        KmerTable, flush_lanes=3 * CHUNK, cap_hinted=True))
    opt = pcount.CountOpts(k=19, bf_shift=19, chunk_size=CHUNK, cap_log2=12,
                           exact=True, device="cpu")
    with contextlib.redirect_stderr(io.StringIO()):
        t = pcount.count([fq, fa], opt)
    assert t.cap > 1 << 12
    assert sum(1 for _ in ChunkSource(fq, CHUNK, 19)) == 7
    assert [f[1] for f in folds if f[0]] == ["periodic"] * 2
    out = str(tmp_path / "p.yak")
    dump_yak_exact(out, t, [fq, fa], bf_shift=19)
    assert open(out, "rb").read() == jax_dumps("b19-gzfq-then-fa")


def test_cheap_gate_fails_cross_check(reads):
    """Without the serial-exact gate, the two-file -b19 input admits other
    pass-1 keys, and the dump's cross-check refuses the table."""
    d, fa, fq = reads
    opt = pcount.CountOpts(k=19, bf_shift=19, chunk_size=CHUNK,
                           device="cpu")
    with contextlib.redirect_stderr(io.StringIO()):
        t = pcount.count([fq, fa], opt)
    with pytest.raises(ValueError, match="cross-check"):
        dump_yak_exact(str(d / "x.yak"), t, [fq, fa], bf_shift=19)


def test_cross_check_catches_tampered_table(reads, tmp_path):
    d, fa, fq = reads
    opt = pcount.CountOpts(k=17, chunk_size=CHUNK, exact=True, device="cpu")
    with contextlib.redirect_stderr(io.StringIO()):
        t = pcount.count([fa], opt)
    out = tmp_path / "x.yak"
    dump_yak_exact(str(out), t, [fa])           # untouched: it dumps
    t.cnt[3] += 1
    with pytest.raises(ValueError, match="cross-check"):
        dump_yak_exact(str(tmp_path / "y.yak"), t, [fa])
    with pytest.raises(ValueError, match="cross-check"):
        dump_yak_exact(str(tmp_path / "z.yak"), t, [fq])


def test_exact_and_default_dumps_same_items(reads, jax_dumps, tmp_path):
    d, fa, _fq = reads
    out = str(tmp_path / "default.yak")
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["count", "-k17", f"-K{CHUNK}", "--device", "cpu",
                         "-o", out, fa]) == 0
    xfile = tmp_path / "x.yak"
    xfile.write_bytes(jax_dumps("plain-k17"))
    a, b = yakfmt.restore_yak(out), yakfmt.restore_yak(str(xfile))
    assert a[:2] == b[:2]
    oa, ob = np.argsort(a[2]), np.argsort(b[2])
    np.testing.assert_array_equal(a[2][oa], b[2][ob])
    np.testing.assert_array_equal(a[3][oa], b[3][ob])
    assert open(out, "rb").read() != xfile.read_bytes()


def test_psort_with_exact_refused(reads, monkeypatch):
    """The psort engine has no serial-exact gate: a gated -X fold under
    YAK_TPU_PSORT=1 raises yak_tpu's RuntimeError, in both packages."""
    d, fa, fq = reads
    monkeypatch.setenv("YAK_TPU_PSORT", "1")
    msgs = []
    for run in (lambda: pcount.count([fq, fa], pcount.CountOpts(
                    k=19, bf_shift=20, chunk_size=CHUNK, exact=True,
                    device="cpu")),
                lambda: jax_cli.main(["count", "-X", "-k19", "-b20",
                                      f"-K{CHUNK}", fq, fa])):
        with pytest.raises(RuntimeError) as e, \
                contextlib.redirect_stderr(io.StringIO()):
            run()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "requires the default engine" in msgs[0]


def test_exact_without_native_library_raises(reads, monkeypatch, tmp_path):
    """-X never falls back: without the native library (here
    YAK_TPU_NO_NATIVE) the CLI's -X raises before it counts, and the
    dump's simulator raises."""
    d, fa, _fq = reads
    monkeypatch.setenv("YAK_TPU_NO_NATIVE", "1")
    out = tmp_path / "x.yak"
    with pytest.raises(RuntimeError, match="native library"):
        cli.main(["count", "-X", "-k17", f"-K{CHUNK}", "--device", "cpu",
                  "-o", str(out), fa])
    assert not out.exists()
    t = KmerTable(17, PRE, device="cpu")
    with pytest.raises(RuntimeError, match="native library"):
        dump_yak_exact(str(out), t, [fa])
