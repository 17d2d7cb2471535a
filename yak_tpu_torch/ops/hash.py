"""yak's 64-bit invertible k-mer hash (yak-priv.h:11-21) in int64 torch.

The key is a canonical 2k-bit packed k-mer (k <= 31) and the mask is
4^k - 1 <= 2^62 - 1.  Additions and left shifts wrap in int64 exactly as
they wrap in uint64 (two's complement), and every step is masked back to
<= 62 bits before the next right shift, so the arithmetic `>>` of int64
is the logical shift the reference uses.
"""


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
