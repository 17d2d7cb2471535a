"""The port's Bloom prefilter (ops/bloom.py), its gate posts
(ops/countstep.bloom_gate_post, bloom_gate_sentinel_post) and the gated
fold's overflow replay (table.KmerTable) against the JAX package's
bloom_insert, get_bloom_gate_post, run_bloom_gate_post (the compaction
in interpret mode) and KmerTable.  Filters are compared word for word
and weights key by key: all comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yak_tpu.ops.bloom import bloom_insert as jax_bloom_insert
from yak_tpu.ops.bloom import make_bloom as jax_make_bloom
from yak_tpu.ops.countstep import (_xs_packed_sorted, _xs_wide_sorted,
                                   get_bloom_gate_post, run_bloom_gate_post)
from yak_tpu.table import KmerTable as JaxTable
from yak_tpu_torch.ops import bloom
from yak_tpu_torch.ops.countstep import (bloom_gate_post,
                                         bloom_gate_sentinel_post,
                                         sort_batch)
from yak_tpu_torch.ops.keys import INT64_MAX, decode_wide, u64_to_torch
from yak_tpu_torch.table import KmerTable

PRE, N_HASH = 10, 4


def _filter_u32(bf):
    return np.asarray(bf.numpy() if isinstance(bf, torch.Tensor) else bf
                      ).view(np.uint32)


@pytest.mark.parametrize("n_shift,wide", [(20, False), (28, False),
                                          (28, True)])
def test_bloom_insert_matches_jax(n_shift, wide):
    """Two inserts in a row (the second sees the first's bits): n_before
    and the filter equal the JAX package's; -b20 takes the dense tail
    (a new filter), -b28 the sparse one (in place), whose undo record
    gives back the filter as it was before the insert."""
    rng = np.random.default_rng(n_shift + wide)
    top = 1 << 64 if wide else 1 << 62
    space = rng.integers(0, top, 3000, dtype=np.uint64)
    bf = bloom.make_bloom(n_shift, "cpu")
    jbf = jax_make_bloom(n_shift)
    for step in range(2):
        h = np.unique(rng.choice(space, 1500))
        active = rng.random(len(h)) < 0.9
        before = bf.clone()
        bf, n_before, undo = bloom.bloom_insert(
            bf, u64_to_torch(h), torch.from_numpy(active), pre=PRE,
            n_shift=n_shift, n_hashes=N_HASH)
        jbf, jn = jax_bloom_insert(jbf, jnp.asarray(h), jnp.asarray(active),
                                   pre=PRE, n_shift=n_shift,
                                   n_hashes=N_HASH)
        np.testing.assert_array_equal(n_before.numpy(), np.asarray(jn))
        np.testing.assert_array_equal(_filter_u32(bf), _filter_u32(jbf))
        assert int((n_before == N_HASH).sum()) > 0 or step == 0
        assert isinstance(undo, tuple) == (n_shift > 22)
        after = bf.clone()
        assert torch.equal(bloom.rollback(bf, undo), before)
        bf = after


def _jax_weights(Ehi, Elo, bw, wide):
    """{raw key: weight} at the run ends of the JAX package's descending
    planes."""
    E = ((np.asarray(Ehi).astype(np.uint64) << np.uint64(32))
         | np.asarray(Elo).astype(np.uint64))
    ends = (E != np.uint64((1 << 64) - 1)) & np.append(E[:-1] != E[1:], True)
    key = E if wide else E >> np.uint64(1)
    return dict(zip(key[ends].tolist(), np.asarray(bw)[ends].tolist()))


def _port_weights(bkeys, w, wide):
    ends = (bkeys != INT64_MAX) & torch.cat(
        [bkeys[:-1] != bkeys[1:], torch.ones(1, dtype=torch.bool)])
    key = (decode_wide(bkeys) if wide else bkeys)[ends].numpy().view(
        np.uint64)
    return dict(zip(key.tolist(), w[ends].tolist()))


@pytest.mark.parametrize("bf_shift,wide", [(20, False), (20, True),
                                           (28, False)])
def test_gate_posts_match_jax(bf_shift, wide):
    """Both of the port's gate posts on its ascending batch == the JAX
    package's plain post (get_bloom_gate_post) on its descending planes,
    over two folds (the second against the first's filter); at -b20 also
    == its sentinel post (run_bloom_gate_post, the compaction kernel in
    interpret mode), as in test_bloom_gate_sentinel_matches_plain_post.
    -b28 runs the plain post's sparse tail."""
    rng = np.random.default_rng(23 + bf_shift + wide)
    top = 1 << 64 if wide else 1 << 62
    space = rng.integers(0, top, 4000, dtype=np.uint64)
    xs_sorted = _xs_wide_sorted if wide else _xs_packed_sorted
    jplain = get_bloom_gate_post(PRE, bf_shift, N_HASH, wide=wide)
    jbf = jax_make_bloom(bf_shift)
    bfs = {"plain": bloom.make_bloom(bf_shift, "cpu"),
           "sentinel": bloom.make_bloom(bf_shift, "cpu")}
    posts = {"plain": bloom_gate_post, "sentinel": bloom_gate_sentinel_post}
    for _fold in range(2):
        batch = rng.choice(space, size=12000).astype(np.uint64)
        valid = rng.random(12000) < 0.95
        Ehi, Elo = xs_sorted(jnp.asarray(batch), jnp.asarray(valid))
        if bf_shift == 20:
            bw_s, bf_s = run_bloom_gate_post(Ehi, Elo, jbf, PRE, bf_shift,
                                             N_HASH, wide=wide,
                                             interpret=True)
        bw, jbf = jplain(Ehi, Elo, jbf)
        want = _jax_weights(Ehi, Elo, bw, wide)
        assert sum(w > 0 for w in want.values()) > 100
        if bf_shift == 20:
            assert _jax_weights(Ehi, Elo, bw_s, wide) == want
            np.testing.assert_array_equal(_filter_u32(bf_s),
                                          _filter_u32(jbf))
        bkeys = sort_batch(u64_to_torch(batch), torch.from_numpy(valid),
                           wide)
        for name, post in posts.items():
            w, bfs[name], _undo = post(bkeys, bfs[name], PRE, bf_shift,
                                       N_HASH, wide)
            assert w.dtype == torch.int32 and w.shape == bkeys.shape
            assert _port_weights(bkeys, w, wide) == want, name
            assert int(w[~torch.cat([bkeys[:-1] != bkeys[1:],
                                     torch.ones(1, dtype=torch.bool)])]
                       .abs().sum()) == 0, name
            np.testing.assert_array_equal(_filter_u32(bfs[name]),
                                          _filter_u32(jbf))


@pytest.mark.parametrize("bf_shift", [20, 31])
def test_gated_fold_overflow_replay_matches_jax(tmp_path, bf_shift):
    """tests/test_table.py::test_bloom_pmerge_overflow_replay on the
    port: every chunk inserted twice into a cap-hinted 2^14 table with
    a live filter, so a gated fold overflows, is caught one fold late,
    and replays at twice the capacity against the pre-fold filter (-b20:
    the sentinel post's kept filter; -b31: the sparse tail's undo
    record).  Items and dump bytes equal the JAX table's."""
    rng = np.random.default_rng(41)
    k = 21
    chunks = [c for c in (rng.integers(0, 4, size=8192).astype(np.uint8)
                          for _ in range(3)) for _ in range(2)]
    tables = [JaxTable(k, cap_log2=14, cap_hinted=True, bf_shift=bf_shift,
                       flush_lanes=8192),
              KmerTable(k, cap_log2=14, cap_hinted=True, flush_lanes=8192,
                        device="cpu", bf_shift=bf_shift)]
    for t in tables:
        assert t.bf is not None
        for c in chunks:
            t.insert_codes(c)
        t.flush()
    assert tables[1].cap > (1 << 14)        # the replay really grew
    for a, b in zip(tables[1].items(), tables[0].items()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_filter_u32(tables[1].bf),
                                  _filter_u32(tables[0].bf))
    paths = [tmp_path / "jax.yak", tmp_path / "port.yak"]
    for t, p in zip(tables, paths):
        t.dump(str(p))
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_filter_lifecycle():
    """A filter only where the reference makes one (9 <= bf_shift - pre
    <= 55); destroy_bf drops it; a raw hash batch through a live filter
    is gated as yak_tpu gates it: a key's first sighting feeds the
    filter, the rest count (four sightings of hash 0 count 3), and an
    increment-only batch creates nothing."""
    assert KmerTable(31, device="cpu", bf_shift=18).bf is None
    assert KmerTable(31, device="cpu", bf_shift=10).bf is None
    t = KmerTable(31, device="cpu", bf_shift=19)
    j = JaxTable(31, bf_shift=19)
    assert t.bf is not None and t.bf.shape == (1 << 14,)
    t.insert_hashes(torch.zeros(4, dtype=torch.int64),
                    torch.ones(4, dtype=torch.bool))
    j.insert_hashes(jnp.zeros(4, jnp.uint64), jnp.ones(4, bool))
    t.insert_hashes(torch.ones(4, dtype=torch.int64),
                    torch.ones(4, dtype=torch.bool), create_new=False)
    for a, b in zip(t.items(), j.items()):
        np.testing.assert_array_equal(a, b)
    assert t.items()[1].tolist() == [3]
    np.testing.assert_array_equal(_filter_u32(t.bf), _filter_u32(j.bf))
    t.destroy_bf()
    assert t.bf is None and t.tot == 1
