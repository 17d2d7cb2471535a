"""yak's 64-bit k-mer hashes (yak-priv.h:11-39) in int64 torch.

`hash64`: the key is a canonical 2k-bit packed k-mer (k <= 31) and the
mask is 4^k - 1 <= 2^62 - 1.  Additions and left shifts wrap in int64
exactly as they wrap in uint64 (two's complement), and every step is
masked back to <= 62 bits before the next right shift, so the
arithmetic `>>` of int64 is the logical shift the reference uses.

`hash64_64` and `hash_long` (k in [32, 63]): the unmasked mix runs over
all 64 bits, so its right shifts are the logical `srl`; `hash_long`
picks the strand by comparing two k-bit planes (below 2^63, so signed
order is right) and returns the wrapping sum of the two mixed planes.

`hash64_inv` (print's getseq) runs on the host in numpy uint64, as the
JAX package runs it.
"""

import numpy as np
import torch

from yak_tpu_torch.ops.keys import srl


def kmer_mask(k):
    return (1 << (2 * k)) - 1


def hash64(key, mask):
    """Invertible hash of int64 keys (< 2^62) under `mask` (= 4^k - 1)."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & mask   # * 265
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & mask   # * 21
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def hash64_64(key):
    """The unmasked mix (yak-priv.h:23-33) of int64 lanes holding u64
    bit patterns."""
    key = ~key + (key << 21)
    key = key ^ srl(key, 24)
    key = (key + (key << 3)) + (key << 8)
    key = key ^ srl(key, 14)
    key = (key + (key << 2)) + (key << 4)
    key = key ^ srl(key, 28)
    return key + (key << 31)


def hash_long(x0, x1, x2, x3):
    """Strand-canonical hash for k in [32, 63] (yak-priv.h:35-39) of the
    four k-bit planes: forward lo/hi (x0, x1), reverse lo/hi (x2, x3)."""
    fwd = x1 < x3
    return (hash64_64(torch.where(fwd, x0, x2))
            + hash64_64(torch.where(fwd, x1, x3)))


_INV21 = np.uint64(14933078535860113213)    # 21^-1 mod 2^64
_INV265 = np.uint64(15244667743933553977)   # 265^-1 mod 2^64


def hash64_inv(key, mask):
    """The exact inverse of hash64 (yak-priv.h:41-68) on the host: numpy
    uint64 hashes -> packed 2-bit k-mers under `mask` (= 4^k - 1,
    k <= 31).  Each mix stage is undone in reverse order: the xor-shifts
    by repeated unmasking, the multiplies by their inverses mod 2^64
    (constants above 2^63, so the arithmetic stays in uint64, where
    numpy's shifts are logical and its products wrap)."""
    u = np.uint64
    key = np.asarray(key, dtype=np.uint64)
    mask = u(mask)
    with np.errstate(over="ignore"):
        tmp = key - (key << u(31))                  # key + (key << 31)
        key = (key - (tmp << u(31))) & mask
        tmp = key ^ (key >> u(28))                  # key ^ key >> 28
        key = key ^ (tmp >> u(28))
        key = (key * _INV21) & mask                 # key * 21
        tmp = key ^ (key >> u(14))                  # key ^ key >> 14
        tmp = key ^ (tmp >> u(14))
        tmp = key ^ (tmp >> u(14))
        key = key ^ (tmp >> u(14))
        key = (key * _INV265) & mask                # key * 265
        tmp = key ^ (key >> u(24))                  # key ^ key >> 24
        key = key ^ (tmp >> u(24))
        tmp = ~key                                  # ~key + (key << 21)
        tmp = ~(key - (tmp << u(21)))
        tmp = ~(key - (tmp << u(21)))
        return ~(key - (tmp << u(21))) & mask
