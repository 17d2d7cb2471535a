"""Seeded stream-compaction cases shared by the port's CPU parity tests
(tests/test_torch_compact.py) and its on-card check (chip_smoke.py).

numpy only at import (offset_planes imports torch when called):
chip_smoke.py imports this module on a machine without JAX.
Each case is (khi uint32, klo uint32, v int32); a lane is dropped where
khi has bit 31 set.  The first group repeats tests/test_pallas.py's
cases and seeds (TPU tile T = 8192 lanes); the second puts the length at
the edges of 2048-lane tiles, with none or all lanes kept; the third at
the edges of the CUDA kernel's tiles (CUDA_TILE, csrc/compact.cu), past
33 of them (so that a look-back crosses its first 32-word step), with
no lanes, half the lanes kept, and planes that start one lane past a
16-byte boundary (`base[1:]` of longer arrays).
"""

import numpy as np

T = 8192          # the TPU kernel's tile (pallas_compact.T)
# the CUDA kernel's tile (csrc/compact.cu): CUDA_NT data threads, each
# making CUDA_Q loads of CUDA_VEC lanes (16 bytes)
CUDA_NT, CUDA_Q, CUDA_VEC = 512, 8, 4
CUDA_TILE = CUDA_NT * CUDA_Q * CUDA_VEC   # 16384 lanes


def random_planes(n, density, seed):
    """n seeded lanes, each kept with probability `density`."""
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


def _unaligned(n, density, seed):
    """Each plane is base[1:] of an array one lane longer, so it starts 4
    bytes past the base's start (a 16-byte boundary, as numpy
    allocates)."""
    out = []
    for a in random_planes(n, density, seed):
        base = np.empty(n + 1, a.dtype)
        base[1:] = a
        out.append(base[1:])
    return tuple(out)


def _case(n, density, seed, pallas):
    return (lambda: random_planes(n, density, seed)), pallas


# name -> (case maker, also run through the Pallas kernel in interpret mode)
CASES = {
    **{f"one_tile_density_{d}": _case(T, d, 1, True)
       for d in (0.0, 0.1, 0.5, 0.9, 1.0)},
    "multi_tile": _case(4 * T, 0.37, 2, True),
    "unaligned_length": _case(3 * T - 1234, 0.6, 3, True),
    "order_preserved": (_order_probe, True),
    "cuda_tile_minus_1_all_kept": _case(2048 - 1, 1.0, 5, False),
    "cuda_tile_none_kept": _case(2048, 0.0, 6, False),
    "cuda_tile_plus_1": _case(2048 + 1, 0.5, 7, False),
    "cuda_tiles_sparse": _case(5 * 2048 + 17, 0.002, 8, False),
    "tile_minus_1_all_kept": _case(CUDA_TILE - 1, 1.0, 9, False),
    "tile_none_kept": _case(CUDA_TILE, 0.0, 10, False),
    "tile_plus_1": _case(CUDA_TILE + 1, 0.5, 11, False),
    "past_33_tiles": _case(34 * CUDA_TILE + 3, 0.25, 12, False),
    "empty": _case(0, 0.5, 13, False),
    "dense_half": _case(3 * CUDA_TILE + 77, 0.5, 14, True),
    "unaligned_planes": ((lambda: _unaligned(2 * CUDA_TILE + 5, 0.4, 15)),
                         True),
}


def as_int32(a):
    """A uint32/int32 numpy plane as int32, bit for bit (a view, so an
    unaligned plane stays unaligned)."""
    return np.ascontiguousarray(a).view(np.int32)


def offset_planes(arrays, dev, offset):
    """numpy planes as int32 torch tensors on `dev`, each starting
    `offset` lanes past the start of its own allocation (so 4 * offset
    bytes past a 16-byte boundary on a CUDA card)."""
    import torch

    out = []
    for a in arrays:
        base = torch.zeros(len(a) + offset, dtype=torch.int32, device=dev)
        base[offset:] = torch.from_numpy(as_int32(a))
        out.append(base[offset:])
    return out


def expected(khi, klo, v):
    """The contract in plain numpy: the kept lanes of each plane, in
    order, and their number (pallas_compact.compact_reference)."""
    keep = khi < (1 << 31)
    return khi[keep], klo[keep], v[keep], int(keep.sum())
