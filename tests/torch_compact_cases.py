"""Seeded stream-compaction cases shared by the port's CPU parity tests
(tests/test_torch_compact.py) and its on-card check (chip_smoke.py).

numpy only: chip_smoke.py imports this module on a machine without JAX.
Each case is (khi uint32, klo uint32, v int32); a lane is dropped where
khi has bit 31 set.  The first group repeats tests/test_pallas.py's
cases and seeds (TPU tile T = 8192 lanes); the second puts the length at
the edges of the CUDA kernel's 2048-lane tiles, with none or all lanes
kept.
"""

import numpy as np

T = 8192          # the TPU kernel's tile (pallas_compact.T)
CUDA_TILE = 2048  # the CUDA kernel's tile (csrc/compact.cu)


def _random(n, density, seed):
    rng = np.random.default_rng(seed)
    keep = rng.random(n) < density
    khi = rng.integers(0, 1 << 31, n).astype(np.uint32)
    khi = np.where(keep, khi, khi | np.uint32(1 << 31))
    klo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    v = rng.integers(-5, 1024, n).astype(np.int32)
    return khi, klo, v


def _order_probe():
    n = 2 * T
    rng = np.random.default_rng(4)
    keep = rng.random(n) < 0.3
    khi = np.arange(n, dtype=np.uint32)   # strictly increasing
    khi = np.where(keep, khi, khi | np.uint32(1 << 31))
    return khi, np.zeros(n, np.uint32), np.arange(n, dtype=np.int32)


# name -> (case maker, also run through the Pallas kernel in interpret mode)
CASES = {
    **{f"one_tile_density_{d}": ((lambda d=d: _random(T, d, 1)), True)
       for d in (0.0, 0.1, 0.5, 0.9, 1.0)},
    "multi_tile": (lambda: _random(4 * T, 0.37, 2), True),
    "unaligned_length": (lambda: _random(3 * T - 1234, 0.6, 3), True),
    "order_preserved": (_order_probe, True),
    "cuda_tile_minus_1_all_kept": (lambda: _random(CUDA_TILE - 1, 1.0, 5),
                                   False),
    "cuda_tile_none_kept": (lambda: _random(CUDA_TILE, 0.0, 6), False),
    "cuda_tile_plus_1": (lambda: _random(CUDA_TILE + 1, 0.5, 7), False),
    "cuda_tiles_sparse": (lambda: _random(5 * CUDA_TILE + 17, 0.002, 8),
                          False),
}


def as_int32(a):
    """A uint32/int32 numpy plane as int32, bit for bit."""
    return np.ascontiguousarray(a).view(np.int32)


def expected(khi, klo, v):
    """The contract in plain numpy: the kept lanes of each plane, in
    order, and their number (pallas_compact.compact_reference)."""
    keep = khi < (1 << 31)
    return khi[keep], klo[keep], v[keep], int(keep.sum())
