"""Plain k-mer counting, the reference of the count cells.

Written from yak's own rules, not from the port: the forward and
reverse-complement 2-bit k-mers of count.c's loop (the first base in
the high bits), the canonical one the smaller, and yak_hash64
(yak-priv.h), frozen here.  Counting is one sort of every window's hash
and a run-length count; the table of `yak count -b` over the reads
given twice is every k-mer seen at least twice, with its count
saturated at 1023 (YAK_MAX_COUNT).  Plain torch, so it runs on the card
after the program's state is freed, a block of reads at a time.
"""

import torch

MAX_COUNT = 1023
N_COUNTS = 1024


def hash64(key, mask):
    """yak_hash64 (yak-priv.h) of int64 keys below 2^62 under `mask` =
    4^k - 1: every step is masked back below 2^62 before the next right
    shift, so int64's arithmetic shift is the logical one."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def window_hashes(codes, k):
    """Hashes of every k-mer window of equal-length sequences.

    codes: uint8 [n, L] of 2-bit bases (0..3, no N); k <= 31.  Returns
    int64 [n, L - k + 1]: yak_hash64 of the smaller of the forward and
    reverse-complement k-mers, window by window in base order."""
    if not 1 <= k <= 31:
        raise ValueError(f"k={k}: the reference counts k <= 31")
    if codes.numel() and int(codes.max()) > 3:
        raise ValueError("the reference takes N-free 2-bit codes")
    n, length = codes.shape
    m = length - k + 1
    c = codes.to(torch.int64)
    fwd = torch.zeros((n, m), dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        col = c[:, j:j + m]
        fwd = (fwd << 2) | col                 # base j at bits 2(k-1-j)
        rev = rev | ((3 - col) << (2 * j))     # its complement at bits 2j
    return hash64(torch.minimum(fwd, rev), (1 << (2 * k)) - 1)


def count(blocks, k):
    """Every distinct hash of the windows of `blocks` (an iterable of
    uint8 [n, L] code blocks) with its number of occurrences: (keys
    int64 ascending, counts int64)."""
    hashes = torch.cat([window_hashes(b, k).reshape(-1) for b in blocks])
    keys, counts = torch.unique(hashes, sorted=True, return_counts=True)
    return keys, counts


def two_pass_table(keys, counts):
    """`yak count -b` over the reads given twice: the keys seen at least
    twice, their counts saturated at 1023."""
    keep = counts >= 2
    return keys[keep], counts[keep].clamp(max=MAX_COUNT)


def hist(counts):
    """The 1024-bin histogram of a table's counts (yak_ch_hist)."""
    return torch.bincount(counts.clamp(max=MAX_COUNT),
                          minlength=N_COUNTS)[:N_COUNTS]


def lookup(tkeys, tcounts, queries):
    """The table count of each query hash, 0 where absent (qv's
    `yak_ch_get` < 0 counts as 0)."""
    if tkeys.numel() == 0:
        return torch.zeros_like(queries)
    pos = torch.searchsorted(tkeys, queries).clamp(max=tkeys.numel() - 1)
    return torch.where(tkeys[pos] == queries, tcounts[pos], 0)
