"""Seeded merge-JOIN (lookup) cases shared by the port's CPU parity tests
(tests/test_torch_join.py) and its on-card check (chip_smoke.py).

numpy only: chip_smoke.py imports this module on a machine without JAX.
Each case is (table hashes, table counts, query hashes, query valid
mask, cap, stale): the table holds the hashes sorted in its first lanes
and `stale` (sorted) after them, beyond its live size, as a table holds
old keys after a restore or a grow.  The first group repeats
tests/test_pallas_merge.py's lookup cases and seeds (the empty-table
case with 20,000 queries instead of 12,000); the rest put a hot
query key's run across 1024-lane tiles (the CUDA kernel's first tile
size), the CUDA kernel's tiles of CUDA_TILE merged lanes and the
8192-lane tiles of the TPU kernel, with its table lane in an earlier
tile, or start a run of misses exactly at a CUDA tile's first lane.
"""

import numpy as np

CAP = 1 << 14
NQ = 20000        # queries of every case (one JAX compile for all)
CUDA_TILE = 4096  # the CUDA kernel's tile (torch_merge_cases.CUDA_TILE)
_NONE = np.zeros(0, np.uint64)


def _basic():
    rng = np.random.default_rng(10)
    space = rng.integers(0, 1 << 62, 60000, dtype=np.uint64)
    hs = rng.choice(space, size=9000, replace=False).astype(np.uint64)
    cs = rng.integers(0, 1024, 9000).astype(np.int32)
    batch = rng.choice(space, size=20000, replace=True).astype(np.uint64)
    valid = rng.random(20000) < 0.95
    return hs, cs, batch, valid, CAP, _NONE


def _dups_and_misses():
    rng = np.random.default_rng(11)
    hot = np.uint64(777777)
    batch = np.full(20000, hot, np.uint64)
    batch[15000:18000] = rng.integers(0, 1 << 62, 3000, dtype=np.uint64)
    valid = np.ones(20000, bool)
    valid[18000:] = False
    return (np.array([hot, 42], np.uint64), np.array([1023, 7], np.int32),
            batch, valid, CAP, _NONE)


def _empty_table():
    rng = np.random.default_rng(12)
    batch = rng.integers(0, 1 << 62, NQ, dtype=np.uint64)
    return _NONE, np.zeros(0, np.int32), batch, np.ones(NQ, bool), CAP, _NONE


def _stale_beyond_size():
    """size < cap with old keys after the live lanes: some equal to
    queries, some smaller than the live keys; none may match."""
    rng = np.random.default_rng(13)
    space = np.unique(rng.integers(0, 1 << 62, 30000, dtype=np.uint64))
    rng.shuffle(space)
    hs, stale = space[:5000], space[5000:9000]
    cs = rng.integers(0, 1024, len(hs)).astype(np.int32)
    batch = rng.choice(np.concatenate([hs, stale, space[9000:]]),
                       size=NQ).astype(np.uint64)
    valid = rng.random(NQ) < 0.97
    return hs, cs, batch, valid, CAP, np.sort(stale)


def _hot_run(n_below, seed, hot_in_table=True):
    """A hot key with n_below smaller table keys and no smaller query,
    so its table lane is merged lane n_below, just before its query run
    (n_below = 1023, 4095 or 8191: the last lane of a tile); the run spans
    several query tiles.  Without its table lane (hot_in_table False) the
    hot key's queries all miss, and their run starts at merged lane
    n_below."""
    rng = np.random.default_rng(seed)
    hot = np.uint64(1 << 50)
    below = np.unique(rng.integers(0, 1 << 49, n_below + 100,
                                   dtype=np.uint64))[:n_below]
    above = np.unique(rng.integers(1 << 51, 1 << 62, 300, dtype=np.uint64))
    hs = np.concatenate([below, np.full(int(hot_in_table), hot, np.uint64),
                         above])
    cs = rng.integers(0, 1024, len(hs)).astype(np.int32)
    batch = np.concatenate([np.full(NQ - 400, hot, np.uint64),
                            rng.choice(above, 200),
                            rng.integers((1 << 50) + 1, 1 << 51, 200,
                                         dtype=np.uint64)])
    rng.shuffle(batch)
    return hs, cs, batch, np.ones(len(batch), bool), CAP, _NONE


CASES = {
    "basic": _basic,
    "dups_and_misses": _dups_and_misses,
    "empty_table": _empty_table,
    "stale_beyond_size": _stale_beyond_size,
    "hot_run_cuda_tile_edge": lambda: _hot_run(1023, 20),
    "hot_run_tpu_tile_edge": lambda: _hot_run(8191, 21),
    "hot_run_mid_tile": lambda: _hot_run(700, 22),
    "table_lane_at_cuda_tile_end": lambda: _hot_run(CUDA_TILE - 1, 23),
    "miss_run_starts_cuda_tile": lambda: _hot_run(CUDA_TILE, 24, False),
}


def table_arrays(hs, cs, cap, stale):
    """(keys uint64 [cap], counts int32 [cap], size): the live hashes
    sorted ascending, then the stale keys with count 5, then (0, -1)."""
    tk = np.zeros(cap, np.uint64)
    tc = np.full(cap, -1, np.int32)
    order = np.argsort(hs)
    n = len(hs)
    tk[:n] = hs[order]
    tc[:n] = cs[order]
    tk[n:n + len(stale)] = stale
    tc[n:n + len(stale)] = 5
    return tk, tc, n


def expected(hs, cs, batch, valid):
    """The contract in plain numpy: each valid query's count, -1 where
    absent or invalid, in query order."""
    t = dict(zip(hs.tolist(), cs.tolist()))
    return np.array([t.get(x, -1) if ok else -1
                     for x, ok in zip(batch.tolist(), valid.tolist())],
                    np.int32)
