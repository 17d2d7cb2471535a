"""The port's KmerTable (yak_tpu_torch/table.py) on the CPU: the
tests/test_table.py cases, the one-fold-late overflow replay, and the
state bridge to a JAX KmerTable.  Exact comparisons."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yak_tpu.table import KmerTable as JaxTable
from yak_tpu_torch.ops.keys import u64_to_torch
from yak_tpu_torch.table import KmerTable


def _table(**kw):
    return KmerTable(device="cpu", **kw)


def _rand_hashes(rng, n):
    base = rng.integers(0, 1 << 62, size=max(n // 2, 1), dtype=np.uint64)
    return base[rng.integers(0, len(base), size=n)]


def _insert(t, h, valid=None, create_new=True):
    v = np.ones(len(h), bool) if valid is None else valid
    t.insert_hashes(u64_to_torch(np.asarray(h, np.uint64)),
                    torch.from_numpy(v), create_new=create_new)


def _as_dict(t):
    h, c = t.items()
    return {int(a): int(b) for a, b in zip(h, c)}


def test_insert_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    h = _rand_hashes(rng, 4096)
    t = _table(k=31, cap_log2=13)
    _insert(t, h)
    want = {}
    for x in h.tolist():
        want[x] = want.get(x, 0) + 1
    assert _as_dict(t) == want
    jt = JaxTable(k=31, cap_log2=13)
    jt.insert_hashes(jnp.asarray(h), jnp.ones(len(h), bool))
    for a, b in zip(t.items(), jt.items()):
        np.testing.assert_array_equal(a, b)


def test_multi_batch_and_growth():
    rng = np.random.default_rng(1)
    t = _table(k=31, cap_log2=10)  # tiny: forces several growths
    want = {}
    for _ in range(6):
        h = _rand_hashes(rng, 2048)
        for x in h.tolist():
            want[x] = min(want.get(x, 0) + 1, 1023)
        _insert(t, h)
    assert _as_dict(t) == want
    assert t.tot == len(want) and t.cap >= len(want)


def test_saturation_at_1023():
    t = _table(k=31, cap_log2=10)
    _insert(t, np.full(2000, 12345, np.uint64))
    _, c = t.items()
    assert list(c) == [1023]


def test_increment_only_mode():
    t = _table(k=31, cap_log2=10)
    _insert(t, [1, 2, 3])
    # create_new=False: key 4 must NOT be created (htab.c:71-75)
    _insert(t, [2, 4, 4], create_new=False)
    assert _as_dict(t) == {1: 1, 2: 2, 3: 1}


def test_clear_set_hist_shrink():
    rng = np.random.default_rng(2)
    t = _table(k=31, cap_log2=12)
    _insert(t, _rand_hashes(rng, 3000))
    hist = t.hist()
    _, c = t.items()
    np.testing.assert_array_equal(hist, np.bincount(c, minlength=1024))
    n2 = int((c >= 2).sum())
    t.shrink(2, 1023)
    assert t.tot == n2
    t.set_counts(7)
    assert set(t.items()[1]) == {7}
    t.clear_counts()
    assert set(t.items()[1]) == {0}


def test_invalid_lanes_ignored():
    t = _table(k=31, cap_log2=10)
    _insert(t, [5, 6, 7, 8], np.array([True, False, True, False]))
    assert sorted(_as_dict(t)) == [5, 7]


def test_codes_overflow_replay_matches_jax(tmp_path):
    """cap 2^14 hinted, one fold per 8192-base chunk: the second fold
    overflows, is detected one fold late, and replays against the
    preserved pre-fold table at twice the capacity; the result equals
    the JAX table's, items and dump bytes."""
    rng = np.random.default_rng(31)
    k = 21
    chunks = [rng.integers(0, 4, size=8192).astype(np.uint8)
              for _ in range(3)]
    tables = [JaxTable(k, cap_log2=14, cap_hinted=True, flush_lanes=8192),
              _table(k=k, cap_log2=14, cap_hinted=True, flush_lanes=8192)]
    for t in tables:
        for c in chunks:
            t.insert_codes(c)
    (href, cref), (h, cnt) = (t.items() for t in tables)
    assert tables[1].cap > (1 << 14)        # the replay really grew
    assert len(h) == len(href) > (1 << 14)
    np.testing.assert_array_equal(h, href)
    np.testing.assert_array_equal(cnt, cref)
    paths = [tmp_path / "jax.yak", tmp_path / "port.yak"]
    for t, p in zip(tables, paths):
        t.dump(str(p))
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_state_bridge_roundtrip():
    """A JAX table's (keys, cnt, size) carried into the port and back:
    both packages then fold the same chunk to the same table."""
    rng = np.random.default_rng(7)
    k = 17
    c1, c2 = (rng.integers(0, 4, size=6000).astype(np.uint8)
              for _ in range(2))
    jt = JaxTable(k, cap_log2=14, cap_hinted=True, flush_lanes=6000)
    jt.insert_codes(c1)
    jt.flush()
    t = KmerTable.from_arrays(np.asarray(jt.keys), np.asarray(jt.cnt),
                              int(jt.size), k, jt.pre, "cpu")
    for a, b in zip(t.items(), jt.items()):
        np.testing.assert_array_equal(a, b)
    t.flush_lanes = 6000
    for tab in (jt, t):
        tab.insert_codes(c2)
    for a, b in zip(t.items(), jt.items()):
        np.testing.assert_array_equal(a, b)

    keys, cnt, n = t.to_arrays()
    assert keys.dtype == np.uint64 and cnt.dtype == np.int32
    assert len(keys) == t.cap and n == t.tot
    assert (keys[n:] == 0).all() and (cnt[n:] == -1).all()
    back = JaxTable(k, cap_log2=14)
    back.keys, back.cnt, back.size = (jnp.asarray(keys), jnp.asarray(cnt),
                                      jnp.int32(n))
    for a, b in zip(back.items(), jt.items()):
        np.testing.assert_array_equal(a, b)


def test_wide_k_not_ported(tmp_path):
    """What the port still refuses about k: k = 64.  The lookups (qv,
    chkerr) against a k >= 32 table now run, with k >= 32 extraction
    (tests/test_torch_wide_lookup.py holds them against the JAX
    package): every window of a sequence is found in the k = 33 table
    counted from it, once."""
    from yak_tpu_torch.models.chkerr import ChkerrOpts, main_chkerr
    from yak_tpu_torch.models.count import CountOpts, count_file
    from yak_tpu_torch.models.qv import QvOpts, run_qv

    with pytest.raises(ValueError, match="63"):
        _table(k=64)
    seq = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(64).integers(0, 4, 300)]
    fa = tmp_path / "one.fa"
    fa.write_bytes(b">s\n" + seq.tobytes() + b"\n")
    t = count_file(str(fa), CountOpts(k=33, device="cpu"))
    assert t.wide and t.tot == 300 - 33 + 1
    cnt = run_qv(QvOpts(), str(fa), t, out=io.StringIO())
    assert int(cnt[1]) == int(cnt.sum()) == 300 - 33 + 1
    out = io.StringIO()
    main_chkerr(ChkerrOpts(), t, str(fa), out=out)
    assert out.getvalue() == "s\t0\t300\t268\n"
