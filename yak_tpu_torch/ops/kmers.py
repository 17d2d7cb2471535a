"""Canonical k-mer extraction (k <= 31) from packed bit planes, as plain
torch ops on int64 lanes.

Port of `yak_tpu/ops/kmers.py` `extract_from_planes` and
`extract_periodic` for k <= 31.  The 2-bit codes arrive split into two
1-bit planes packed LSB-first into u32 words (`io/pack.py`), carried here
in int64 lanes.  Every window's k-bit plane value comes from one funnel
shift `w[q] >> r | w[q+1] << (32-r)` broadcast over all (q, r); forward
values need the window bits reversed (a 5-step bit reverse),
reverse-complement values are the complemented window; a 5-step Morton
spread interleaves the two planes into the 2k-bit packed k-mer, and
yak's invertible hash applies (`ops/hash.py`).

Lanes come out in natural base order ([B, L-k+1]); the TPU's r-major
[G, 32, W-1] layout exists only for its (8, 128) tiling and is not
ported, since the count path sorts the batch anyway.  The JAX package
runs this step in XLA, so plain torch is its port.
"""

import torch

from yak_tpu_torch.ops.hash import hash64, kmer_mask


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


def _check_k(k):
    if not 1 <= k <= 31:
        raise NotImplementedError(
            f"k={k}: the port extracts k <= 31 only; k >= 32 (the "
            f"hash_long wide path) is ROADMAP Queue 1 step 10")


def extract_from_planes(plo, phi, pnn, k, L):
    """Canonical k-mer hashes from pre-packed planes.

    plo/phi/pnn: int64 [B, (L+31)//32 + 1] holding LSB-first u32 words;
    positions >= L must be marked nn=1.  Returns (hashes int64 [B, M],
    valid bool [B, M]) with M = L-k+1; a window is valid iff it holds no
    N."""
    _check_k(k)
    M = L - k + 1
    valid = _funnel(pnn, k, M) == 0
    return _hashes_from_planes(plo, phi, k, M), valid


def extract_periodic(plo, phi, wvec, k, L, R):
    """Canonical k-mer hashes for the fixed-length-read layout: reads of
    length R separated by single N cells, with an all-N tail from base
    wvec[g] on (`io/pack.detect_periodic`).  Window i is valid iff it
    stays inside one period (i mod (R+1) <= R-k) and ends before the pad
    (i + k <= w); no N plane is consulted."""
    _check_k(k)
    M = L - k + 1
    h = _hashes_from_planes(plo, phi, k, M)
    i = torch.arange(M, dtype=torch.int64, device=h.device)
    valid = ((i % (R + 1) <= R - k)[None, :]
             & (i[None, :] < (wvec.to(torch.int64) - (k - 1))[:, None]))
    return h, valid

