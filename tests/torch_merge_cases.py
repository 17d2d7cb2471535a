"""Seeded merge-reduce cases shared by the port's CPU parity tests
(tests/test_torch_merge.py) and its on-card check (chip_smoke.py).

numpy only: chip_smoke.py imports this module on a machine without JAX.
Each case of CASES is (table hashes, table counts, batch hashes, batch
valid mask, cap, create).  The first group repeats
tests/test_pallas_merge.py's cases and seeds (TPU tile = 8192 lanes);
the second puts key runs at the edges of 1024-lane tiles (the CUDA
kernel's first tile size); the third at the edges of the CUDA kernel's
tiles of CUDA_TILE merged lanes, with runs and an INT64_MAX tail over
several tiles, a random case of over 64 tiles and a full table that
overflows.

MODE_CASES hold the weighted (Bloom-gated) and wide (k >= 32) modes:
(table hashes, table counts, batch hashes, batch valid mask, batch
weights or None, cap, create, wide), hashes as raw uint64.  The wide
cases use all 64 bits, with keys >= 2^63, the raw values that encode to
INT64_MIN and -1 (0 and 2^63 - 1) at the stream's ends, and the 0xFF..FF clamp
of tests/test_pallas_merge.py::test_wide_merge_create_false_and_clamp;
the weighted cases put zero-weight runs across tiles.

CUDA_TILE is the CUDA kernel's tile (yak_merge_reduce_tile() in
yak_tpu_torch/csrc/merge_reduce.cu; chip_smoke.py checks that the two
agree).
"""

import numpy as np

CAP = 1 << 14
CUDA_TILE = 4096
U64_MAX = (1 << 64) - 1
SIGN = np.uint64(1 << 63)
INT64_MAX = (1 << 63) - 1


def _random_case(seed, n_table, n_batch, space_n, create=True, cap=CAP):
    rng = np.random.default_rng(seed)
    space = rng.integers(0, 1 << 62, space_n, dtype=np.uint64)
    hs = rng.choice(space, size=n_table, replace=False).astype(np.uint64)
    cs = rng.integers(0, 900, n_table).astype(np.int32)
    batch = rng.choice(space, size=n_batch, replace=True).astype(np.uint64)
    valid = rng.random(n_batch) < 0.97
    return hs, cs, batch, valid, cap, create


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


def _multi_tile_hit(create):
    """A table key's run over more than three CUDA tiles, its table lane
    (and a smaller table key) in the first tile, then batch-only keys;
    with create=False the run is kept and the batch-only keys dropped."""
    hot = np.uint64(999)
    batch = np.concatenate([np.full(3 * CUDA_TILE + 100, hot, np.uint64),
                            np.arange(2000, 2300, dtype=np.uint64)])
    return (np.array([5, hot, 1 << 40], np.uint64),
            np.array([3, 7, 11], np.int32), batch, np.ones(len(batch), bool),
            CAP, create)


def _invalid_tail():
    """A few valid lanes, then an INT64_MAX tail over several CUDA tiles
    behind the partly filled tile that holds the last valid lane."""
    rng = np.random.default_rng(31)
    space = rng.integers(0, 1 << 62, 3000, dtype=np.uint64)
    hs = rng.choice(space, size=1000, replace=False).astype(np.uint64)
    batch = rng.choice(space, size=22000).astype(np.uint64)
    valid = np.zeros(22000, bool)
    valid[:5000] = True
    return (hs, rng.integers(0, 900, 1000).astype(np.int32), batch, valid,
            CAP, True)


def _full_overflow():
    """size = cap: a full table and new keys, so new_size > cap."""
    rng = np.random.default_rng(32)
    space = rng.choice(1 << 40, 30000, replace=False).astype(np.uint64)
    return (space[:CAP], rng.integers(1, 900, CAP).astype(np.int32),
            rng.choice(space, size=9000).astype(np.uint64),
            np.ones(9000, bool), CAP, True)


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
    "cuda_tile_4095": (lambda: _hot_run(CUDA_TILE - 1), False),
    "cuda_tile_4096": (lambda: _hot_run(CUDA_TILE), False),
    "cuda_tile_4097": (lambda: _hot_run(CUDA_TILE + 1), False),
    "cuda_table_hit_over_3_tiles": (lambda: _multi_tile_hit(True), False),
    "cuda_create_false_carried_hit": (lambda: _multi_tile_hit(False), False),
    "cuda_invalid_tail_tiles": (_invalid_tail, False),
    "cuda_random_over_64_tiles": (
        lambda: _random_case(33, 60000, 230000, 150000, cap=1 << 18), False),
    "cuda_full_table_overflow": (_full_overflow, False),
}


def _wide_space(rng, n):
    space = rng.integers(0, 1 << 64, n, dtype=np.uint64)
    return np.where(space == np.uint64(U64_MAX), space - np.uint64(1), space)


def _wide_random(seed, create=True, weighted=False):
    """tests/test_pallas_merge.py::test_wide_merge_matches_xla_step's
    shape: full-width keys, half the space in the table."""
    rng = np.random.default_rng(seed)
    space = _wide_space(rng, 4000)
    batch = rng.choice(space, size=12000).astype(np.uint64)
    valid = rng.random(12000) < 0.95
    hs = np.unique(rng.choice(space, size=2000)).astype(np.uint64)
    cs = np.full(len(hs), 7, np.int32)
    w = rng.integers(0, 4, 12000).astype(np.int32) if weighted else None
    return hs, cs, batch, valid, w, CAP, create, True


def _wide_clamp(create):
    """tests/test_pallas_merge.py::test_wide_merge_create_false_and_clamp:
    a table key >= 2^63, a batch-only key, and three valid 0xFF..FF."""
    present = np.uint64(1 << 63) | np.uint64(12345)
    inf = np.uint64(U64_MAX)
    batch = np.concatenate([
        np.array([present] * 5 + [42] * 4 + [inf] * 3, np.uint64),
        np.zeros(16384 - 12, np.uint64)])
    valid = np.zeros(16384, bool)
    valid[:12] = True
    return (np.array([present], np.uint64), np.array([3], np.int32), batch,
            valid, None, CAP, create, True)


def _wide_edges(single_run):
    """Keys whose encodings are the narrow mode's "no lane" value -1
    (raw 2^63 - 1) and INT64_MIN (raw 0) at the ends of the merged
    stream, over the first 1024-lane tile edge: one run of raw 2^63 - 1
    through the whole stream, or raw 0 first and raw 2^63 - 1 last."""
    lo, minus1 = np.uint64(0), np.uint64((1 << 63) - 1)
    if single_run:
        hs, cs = np.array([minus1], np.uint64), np.array([2], np.int32)
        batch = np.full(1030, minus1, np.uint64)
    else:
        hs, cs = np.array([lo], np.uint64), np.array([2], np.int32)
        batch = np.concatenate([np.full(3, lo, np.uint64),
                                np.full(1030, minus1, np.uint64)])
    return hs, cs, batch, np.ones(len(batch), bool), None, CAP, True, True


def _wide_run_cuda_edge():
    """Raw 0 (INT64_MIN encoded) first, then a run of raw 2^63 - 1
    (encoded -1) over the first CUDA tile edge to the stream's end."""
    lo, minus1 = np.uint64(0), np.uint64((1 << 63) - 1)
    batch = np.concatenate([np.full(3, lo, np.uint64),
                            np.full(CUDA_TILE + 10, minus1, np.uint64)])
    return (np.array([minus1], np.uint64), np.array([4], np.int32), batch,
            np.ones(len(batch), bool), None, CAP, True, True)


def _weighted_run_cuda_edges(last_weight, spread=0):
    """A table-less key's run over two CUDA tile edges (lanes 100 to
    2 CUDA_TILE + 200), behind and before other keys; every lane weighs
    0, or all but the run's last, which weighs last_weight; with spread,
    also one lane in each of the run's first two tiles, so that the sum
    carried into its last tile is small and made of both."""
    a, b, c = np.uint64(1000), np.uint64(2000), np.uint64(3000)
    n = 2 * CUDA_TILE + 100
    batch = np.concatenate([np.full(100, a, np.uint64),
                            np.full(n, b, np.uint64),
                            np.full(50, c, np.uint64)])
    w = np.ones(len(batch), np.int32)
    w[100:100 + n] = 0
    w[100 + n - 1] = last_weight
    w[[150, CUDA_TILE + 150]] = spread
    return (np.array([c], np.uint64), np.array([6], np.int32), batch,
            np.ones(len(batch), bool), w, CAP, True, False)


def _weighted_random(seed, create=True):
    rng = np.random.default_rng(seed)
    space = rng.integers(0, 1 << 62, 6000, dtype=np.uint64)
    hs = rng.choice(space, size=3000, replace=False).astype(np.uint64)
    cs = rng.integers(0, 900, 3000).astype(np.int32)
    batch = rng.choice(space, size=12000).astype(np.uint64)
    valid = rng.random(12000) < 0.97
    w = np.where(rng.random(12000) < 0.3, 0,
                 rng.integers(1, 4, 12000)).astype(np.int32)
    return hs, cs, batch, valid, w, CAP, create, False


def _weighted_zero_runs():
    """A table-less key of 3000 zero-weight lanes (spans tiles: must not
    be created), a table-less key of 2500 lanes whose last lane weighs 5,
    and a table key whose 1500 lanes all weigh 0 (kept, count kept)."""
    a, b, c = np.uint64(1000), np.uint64(2000), np.uint64(3000)
    batch = np.concatenate([np.full(3000, a, np.uint64),
                            np.full(2500, b, np.uint64),
                            np.full(1500, c, np.uint64)])
    w = np.zeros(len(batch), np.int32)
    w[3000 + 2499] = 5
    return (np.array([c, 77], np.uint64), np.array([11, 4], np.int32), batch,
            np.ones(len(batch), bool), w, CAP, True, False)


MODE_B = 16384    # every mode case's batch, padded with invalid lanes


def _padded(build):
    """A mode case with its batch padded to MODE_B lanes (invalid, weight
    0), so that the cases share their compiled shapes in the tests."""
    def make():
        hs, cs, batch, valid, w, cap, create, wide = build()
        n = MODE_B - len(batch)
        return (hs, cs, np.concatenate([batch, np.zeros(n, np.uint64)]),
                np.concatenate([valid, np.zeros(n, bool)]),
                None if w is None else np.concatenate(
                    [w, np.zeros(n, np.int32)]), cap, create, wide)
    return make


MODE_CASES = {name: _padded(build) for name, build in {
    "weighted_random": lambda: _weighted_random(11),
    "weighted_create_false": lambda: _weighted_random(12, create=False),
    "weighted_zero_runs_across_tiles": _weighted_zero_runs,
    "wide_random": lambda: _wide_random(23),
    "wide_create_false_clamp": lambda: _wide_clamp(False),
    "wide_create_true_clamp": lambda: _wide_clamp(True),
    "wide_sign_single_run": lambda: _wide_edges(True),
    "wide_sign_stream_ends": lambda: _wide_edges(False),
    "weighted_wide": lambda: _wide_random(29, weighted=True),
    "weighted_zero_run_cuda_edges": lambda: _weighted_run_cuda_edges(0),
    "weighted_last_lane_cuda_edges": lambda: _weighted_run_cuda_edges(5),
    "weighted_small_sums_cuda_edges": lambda: _weighted_run_cuda_edges(1, 2),
    "wide_run_cuda_edge": _wide_run_cuda_edge,
}.items()}


def sorted_table(hs, cs, cap, wide=False):
    """Table arrays (keys uint64 [cap], counts int32 [cap]) as the JAX
    tests build them: live keys sorted ascending, then (0, -1).  wide:
    the keys come back wide-encoded (h ^ 2^63), the port's table
    encoding for k >= 32."""
    tk = np.zeros(cap, np.uint64)
    tc = np.full(cap, -1, np.int32)
    order = np.argsort(hs)
    tk[:len(hs)] = hs[order] ^ SIGN if wide else hs[order]
    tc[:len(hs)] = cs[order]
    return tk, tc


def sorted_batch(batch, valid, weights=None, wide=False):
    """The batch as the count path hands it to the merge: keys as int64
    bit patterns (wide: 0xFF..FF clamped, then ^ 2^63), ascending, with
    the invalid lanes INT64_MAX at the tail; and the weights (or None)
    in the same order."""
    keys = batch.copy()
    if wide:
        keys = np.where(keys == np.uint64(U64_MAX), keys - np.uint64(1), keys)
        keys = keys ^ SIGN
    keys = np.where(valid, keys.view(np.int64), INT64_MAX)
    order = np.argsort(keys, kind="stable")
    return keys[order], None if weights is None else weights[order]


def expected(hs, cs, batch, valid, cap, create, weights=None, wide=False):
    """The contract in plain numpy: (keys, counts, new_size, n_new) with
    new_size counted before truncation and keys/counts cut at cap.  Keys
    are raw uint64 in unsigned order; a key absent from the table is
    created when its batch weight sum is above 0 (1 a valid lane without
    weights); wide: a raw 0xFF..FF counts as 0xFF..FE."""
    t = dict(zip(hs.tolist(), cs.tolist()))
    w = np.ones(len(batch), np.int64) if weights is None else weights
    add = {}
    for x, wx in zip(batch[valid].tolist(), w[valid].tolist()):
        if wide and x == U64_MAX:
            x -= 1
        add[x] = add.get(x, 0) + wx
    out = {}
    for key in set(t) | set(add):
        if key in t or (create and add[key] > 0):
            out[key] = min(t.get(key, 0) + add.get(key, 0), 1023)
    keys = np.array(sorted(out), np.uint64)
    cnts = np.array([out[x] for x in keys.tolist()], np.int32)
    n_new = sum(1 for key in out if key not in t)
    return keys[:cap], cnts[:cap], len(out), n_new
