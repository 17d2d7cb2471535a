"""k-mer extraction from packed bit planes, as plain torch ops on int64
lanes: canonical `hash64` hashes for k <= 31, `hash_long` hashes for k
in [32, 63].

Port of `yak_tpu/ops/kmers.py` `extract_from_planes` and
`extract_periodic`.  The 2-bit codes arrive split into two 1-bit planes
packed LSB-first into u32 words (`io/pack.py`), carried here in int64
lanes.  Every window's k-bit plane value comes from one funnel shift
`w[q] >> r | w[q+1] << (W-r)` broadcast over all (q, r):

- k <= 31: over the u32 words (W = 32); forward values need the window
  bits reversed (a 5-step bit reverse), reverse-complement values are
  the complemented window; a 5-step Morton spread interleaves the two
  planes into the 2k-bit packed k-mer, and yak's invertible hash
  applies (`ops/hash.py`);
- k >= 32: over u64 words (W = 64, two u32 words merged); the four
  1-bit planes of count.c:45-60 are the bit-reversed windows (forward)
  and the complemented windows (reverse), and `hash_long` combines
  them.  Every right shift of a 64-bit word here is the logical `srl`.

Lanes come out in natural base order ([B, L-k+1]); the TPU's r-major
[G, 32, W-1] layout exists only for its (8, 128) tiling and is not
ported, since the count path sorts the batch anyway.  The JAX package
runs this step in XLA, so plain torch is its port.
"""

import torch

from yak_tpu_torch.ops.hash import hash64, hash_long, kmer_mask
from yak_tpu_torch.ops.keys import srl

MAX_K = 63


def _funnel(words, k, M):
    """All k-bit windows of a packed bit stream.

    words: int64 [B, W] holding u32 words; returns int64 [B, M] where
    out[:, i] = bits i .. i+k-1 of the stream (LSB = first base)."""
    B, W = words.shape
    lo = words[:, :-1, None]
    hi = words[:, 1:, None]
    r = torch.arange(32, dtype=torch.int64, device=words.device)
    win = (lo >> r) | (hi << (32 - r))
    return (win.reshape(B, (W - 1) * 32)[:, :M]) & ((1 << k) - 1)


def _bitrev(x, k):
    """Reverse the low k (<= 31) bits of lanes holding u32 values."""
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    x = ((x & 0x0000FFFF) << 16) | ((x >> 16) & 0x0000FFFF)
    return x >> (32 - k)


def _spread(x):
    """Morton spread: bit i -> bit 2i (the low 31 bits are used)."""
    x = (x | (x << 16)) & 0x0000FFFF0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0F
    x = (x | (x << 2)) & 0x3333333333333333
    x = (x | (x << 1)) & 0x5555555555555555
    return x


def _hashes_from_planes(plo, phi, k, M):
    wlo = _funnel(plo, k, M)          # bit j = base i+j
    whi = _funnel(phi, k, M)
    mk = (1 << k) - 1
    fwd = _spread(_bitrev(wlo, k)) | (_spread(_bitrev(whi, k)) << 1)
    rev = _spread((~wlo) & mk) | (_spread((~whi) & mk) << 1)
    return hash64(torch.minimum(fwd, rev), kmer_mask(k))


def _words64(p32):
    """u32 plane words [B, W] -> u64 words [B, ceil(W/2) + 1] (int64 bit
    patterns): pairs merged, plus one zero word past the end (the
    64-bit funnel reads w[q+1])."""
    B, W = p32.shape
    if W % 2:
        p32 = torch.cat([p32, p32.new_zeros(B, 1)], dim=1)
    p = p32.reshape(B, -1, 2)
    w = p[:, :, 0] | (p[:, :, 1] << 32)
    return torch.cat([w, w.new_zeros(B, 1)], dim=1)


def _funnel64(words, k, M):
    """All k-bit (k <= 63) windows of a packed bit stream, from u64
    words: out[:, i] = bits i .. i+k-1 (LSB = first base)."""
    B, W = words.shape
    lo = words[:, :-1, None]
    hi = words[:, 1:, None]
    r = torch.arange(64, dtype=torch.int64, device=words.device)
    # srl(lo, r) with r a lane vector: the arithmetic shift, masked
    keep = torch.tensor([-1] + [(1 << (64 - s)) - 1 for s in range(1, 64)],
                        dtype=torch.int64, device=words.device)
    win = ((lo >> r) & keep) | ((hi << (63 - r)) << 1)
    return win.reshape(B, (W - 1) * 64)[:, :M] & ((1 << k) - 1)


def _bitrev64(x, k):
    """Reverse the low k (<= 63) bits of int64 lanes (6-step swap)."""
    for s, m in ((1, 0x5555555555555555), (2, 0x3333333333333333),
                 (4, 0x0F0F0F0F0F0F0F0F), (8, 0x00FF00FF00FF00FF),
                 (16, 0x0000FFFF0000FFFF)):
        x = ((x & m) << s) | (srl(x, s) & m)
    x = (x << 32) | srl(x, 32)
    return srl(x, 64 - k)


def _hash_long_from_planes(plo, phi, k, M):
    """yak_hash_long (k in [32, 63]) of every window: forward planes are
    the bit-reversed windows (bit k-1-j), reverse planes the complemented
    windows (bit j), as in kmers._hash_long_from_planes."""
    wlo = _funnel64(_words64(plo), k, M)
    whi = _funnel64(_words64(phi), k, M)
    mask = (1 << k) - 1
    return hash_long(_bitrev64(wlo, k), _bitrev64(whi, k),
                     (~wlo) & mask, (~whi) & mask)


def _check_k(k):
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: k must be in [1, {MAX_K}]")


def _hashes(plo, phi, k, M):
    if k <= 31:
        return _hashes_from_planes(plo, phi, k, M)
    return _hash_long_from_planes(plo, phi, k, M)


def extract_from_planes(plo, phi, pnn, k, L):
    """k-mer hashes from pre-packed planes: canonical hash64 for k <= 31,
    yak_hash_long (int64 bit patterns of the u64 hashes) for k >= 32.

    plo/phi/pnn: int64 [B, (L+31)//32 + 1] holding LSB-first u32 words;
    positions >= L must be marked nn=1.  Returns (hashes int64 [B, M],
    valid bool [B, M]) with M = L-k+1; a window is valid iff it holds no
    N."""
    _check_k(k)
    M = L - k + 1
    if k <= 31:
        valid = _funnel(pnn, k, M) == 0
    else:
        valid = _funnel64(_words64(pnn), k, M) == 0
    return _hashes(plo, phi, k, M), valid


def extract_periodic(plo, phi, wvec, k, L, R):
    """k-mer hashes for the fixed-length-read layout: reads of length R
    separated by single N cells, with an all-N tail from base wvec[g] on
    (`io/pack.detect_periodic`).  Window i is valid iff it stays inside
    one period (i mod (R+1) <= R-k) and ends before the pad
    (i + k <= w); no N plane is consulted."""
    _check_k(k)
    M = L - k + 1
    h = _hashes(plo, phi, k, M)
    i = torch.arange(M, dtype=torch.int64, device=h.device)
    valid = ((i % (R + 1) <= R - k)[None, :]
             & (i[None, :] < (wvec.to(torch.int64) - (k - 1))[:, None]))
    return h, valid
