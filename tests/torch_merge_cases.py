"""Seeded merge-reduce cases shared by the port's CPU parity tests
(tests/test_torch_merge.py) and its on-card check (chip_smoke.py).

numpy only: chip_smoke.py imports this module on a machine without JAX.
Each case is (table hashes, table counts, batch hashes, batch valid mask,
cap, create).  The first group repeats tests/test_pallas_merge.py's
cases and seeds (TPU tile = 8192 lanes); the second puts key runs at the
edges of the CUDA kernel's 1024-lane tiles.
"""

import numpy as np

CAP = 1 << 14


def _random_case(seed, n_table, n_batch, space_n, create=True):
    rng = np.random.default_rng(seed)
    space = rng.integers(0, 1 << 62, space_n, dtype=np.uint64)
    hs = rng.choice(space, size=n_table, replace=False).astype(np.uint64)
    cs = rng.integers(0, 900, n_table).astype(np.int32)
    batch = rng.choice(space, size=n_batch, replace=True).astype(np.uint64)
    valid = rng.random(n_batch) < 0.97
    return hs, cs, batch, valid, CAP, create


def _heavy():
    rng = np.random.default_rng(1)
    hot = np.uint64(12345)
    batch = np.full(20000, hot, np.uint64)
    batch[17000:] = rng.integers(0, 1 << 62, 3000, dtype=np.uint64)
    return (np.array([hot, 77], np.uint64), np.array([5, 3], np.int32),
            batch, np.ones(20000, bool), CAP, True)


def _empty_overflow():
    rng = np.random.default_rng(3)
    space = rng.integers(0, 1 << 62, 40000, dtype=np.uint64)
    batch = rng.choice(space, size=30000).astype(np.uint64)
    return (np.zeros(0, np.uint64), np.zeros(0, np.int32), batch,
            np.ones(30000, bool), CAP, True)


def _hot_run(n_hot, table=None):
    hot = np.uint64(999)
    later = np.uint64(1 << 40)
    batch = np.concatenate([np.full(n_hot, hot, np.uint64),
                            np.full(300, later, np.uint64)])
    hs, cs = table if table is not None else (np.zeros(0, np.uint64),
                                              np.zeros(0, np.int32))
    return hs, cs, batch, np.ones(len(batch), bool), CAP, True


def _carried_dropped():
    hot = np.uint64(4242)   # spans tiles, absent from the table
    return (np.array([77], np.uint64), np.array([9], np.int32),
            np.full(12000, hot, np.uint64), np.ones(12000, bool), CAP,
            False)


# name -> (case maker, also run through the Pallas kernel in interpret mode)
CASES = {
    "basic_multi_tile": (lambda: _random_case(0, 9000, 20000, 60000), True),
    "heavy_duplicates_saturation": (_heavy, True),
    "create_false": (lambda: _random_case(2, 7000, 12000, 30000,
                                          create=False), True),
    "empty_table_overflow": (_empty_overflow, True),
    "tile_edge_8191": (lambda: _hot_run(8191), True),
    "tile_edge_8192": (lambda: _hot_run(8192), True),
    "tile_edge_8193": (lambda: _hot_run(8193), True),
    "tile_edge_16384": (lambda: _hot_run(16384), True),
    "create_false_carried_batch_only": (_carried_dropped, True),
    "cuda_tile_edge_1023": (lambda: _hot_run(1023), False),
    "cuda_tile_edge_1024": (lambda: _hot_run(1024), False),
    "cuda_tile_edge_1025": (lambda: _hot_run(1025), False),
    "cuda_tile_edge_table_hit": (
        lambda: _hot_run(2047, (np.array([999, 5], np.uint64),
                                np.array([1000, 2], np.int32))), False),
}


def sorted_table(hs, cs, cap):
    """Table arrays (keys uint64 [cap], counts int32 [cap]) as the JAX
    tests build them: live keys sorted ascending, then (0, -1)."""
    tk = np.zeros(cap, np.uint64)
    tc = np.full(cap, -1, np.int32)
    order = np.argsort(hs)
    tk[:len(hs)] = hs[order]
    tc[:len(hs)] = cs[order]
    return tk, tc


def expected(hs, cs, batch, valid, cap, create):
    """The contract in plain numpy: (keys, counts, new_size, n_new) with
    new_size counted before truncation and keys/counts cut at cap."""
    t = dict(zip(hs.tolist(), cs.tolist()))
    add = {}
    for x in batch[valid].tolist():
        add[x] = add.get(x, 0) + 1
    out = {}
    for key in set(t) | set(add):
        if key in t or create:
            out[key] = min(t.get(key, 0) + add.get(key, 0), 1023)
    keys = np.array(sorted(out), np.uint64)
    cnts = np.array([out[x] for x in keys.tolist()], np.int32)
    n_new = sum(1 for key in out if key not in t)
    return keys[:cap], cnts[:cap], len(out), n_new
