"""Pack variable-length sequences into fixed-shape device chunks.

The device folds want fixed shapes; genomics inputs are ragged.  Instead
of padding each sequence to a bucket (shape churn, wasted lanes), all
sequences in a batch are concatenated into ONE flat code buffer of a
fixed size, separated by a single N code (4).  k-mer windows that span a
separator contain an N and are invalid — which is *exactly* the
reference's "N restarts the window" semantics (count.c:41), so
per-sequence k-mer sets fall out of the flat layout for free.

Sequences longer than the remaining chunk space are split with a
(k-1)-base halo: the continuation chunk re-reads the last k-1 bases so
every window is produced exactly once (the sequence-parallel analogue
noted in SURVEY §5).

Per-position metadata (sequence id, base offset) is built host-side as
NumPy arrays for the per-sequence workloads (qv/trio/sexchr/chkerr).

Port of `yak_tpu/io/pack.py`.  The count fold uploads its grouped
planes itself (`table.KmerTable._fold_codes`); the lookup workloads
upload one chunk at a time through `pack_chunk_planes`.
"""

import numpy as np
import torch

from yak_tpu_torch.ops.keys import u32_to_torch


def pack_planes(codes):
    """Host-side bit-plane packing of u8 base codes [L] or [B, L] into
    LSB-first u32 planes (lo, hi, nn) of [B, W] with W = (L+31)//32 + 1
    (one word of padding past the last base: the funnel reads w[q+1]).

    The hot ingest path: the h2d transfer then carries 3 bits/base
    (2-bit code + N mask) instead of 8, and the device skips the plane
    packing entirely (ops/kmers.extract_from_planes).  np.packbits with
    bitorder='little' + a little-endian u32 view yields exactly the
    "bit j of word w = base 32w+j" layout the funnel shift expects.
    """
    codes = np.atleast_2d(codes)
    B, L = codes.shape
    W = (L + 31) // 32 + 1
    padL = W * 32
    if padL != L:
        codes = np.concatenate(
            [codes, np.full((B, padL - L), 4, np.uint8)], axis=1)
    out = []
    for bits in (codes & 1, (codes >> 1) & 1, codes >= 4):
        b = np.packbits(np.ascontiguousarray(bits), axis=1,
                        bitorder="little")
        out.append(b.view(np.uint32).reshape(B, W))
    return tuple(out)


def pack_planes2(codes):
    """Like pack_planes but lo/hi only (2 bits/base on the wire), for
    chunks whose N layout is periodic (detect_periodic): validity is
    then recomputed on device from (R, w) alone
    (ops/kmers.extract_periodic)."""
    codes = np.atleast_2d(codes)
    B, L = codes.shape
    W = (L + 31) // 32 + 1
    padL = W * 32
    if padL != L:
        codes = np.concatenate(
            [codes, np.full((B, padL - L), 4, np.uint8)], axis=1)
    out = []
    for bits in (codes & 1, (codes >> 1) & 1):
        b = np.packbits(np.ascontiguousarray(bits), axis=1,
                        bitorder="little")
        out.append(b.view(np.uint32).reshape(B, W))
    return tuple(out)


def detect_periodic(codes):
    """Detect the fixed-length-read layout of a flat code chunk:
    `[R bases][N] * m  [<= R tail bases]  [all-N pad]`.

    Returns (R, w) — read length and pad start (number of leading cells
    that are not tail pad) — or None if the chunk's N set is not exactly
    {j*(R+1)+R : j < m} ∪ [w, L).  With (R, w), window validity is pure
    iota arithmetic on device and the N plane need not be transferred.
    """
    L = codes.shape[0]
    isn = codes >= 4
    pad = int(np.argmax(~isn[::-1]))  # length of the all-N tail
    if isn[L - 1 - pad]:
        return None          # all N; let the general path pad
    w = L - pad              # last non-N + 1
    ns = np.flatnonzero(isn[:w])
    if ns.size == 0:
        return (w, w)        # single unbroken run then pad
    R = int(ns[0])
    if not np.array_equal(ns, R + (R + 1) * np.arange(ns.size)):
        return None
    if w - int(ns[-1]) - 1 > R:   # tail run longer than a read
        return None
    return (R, w)


def detect_periodic_meta(packed):
    """detect_periodic from record-piece metadata in O(nseq) — no code
    scan (the scan costs ~100ms per 2^23 chunk, which dominates the
    host side of the lookup workloads).  Requires N-free records (the
    packer writes record bases verbatim, so an N inside a record breaks
    the single-N-separator period) — callers' extract_periodic validity
    would be wrong for N-bearing records, hence the N probe below."""
    rl, rs, rt = packed.rec_len, packed.rec_start, packed.rec_take
    m = len(rl)
    if m <= 1:
        # A single record trivially satisfies the layout test with
        # R = its full length; periodicity buys nothing without
        # separators, so use the general 3-plane path (as the JAX
        # package does, which keeps the fold paths of the two packages
        # the same).
        return None
    R = int(rl[0])
    if R < 1:
        return None
    if not ((rl[:-1] == R).all() and (rt[:-1] == rl[:-1]).all()
            and int(rt[-1]) <= R and int(rl[-1]) >= int(rt[-1])
            and int(rs[-1]) + int(rt[-1]) <= len(packed.codes)
            and (rs == (R + 1) * np.arange(m, dtype=rs.dtype)).all()
            and int(packed.rec_off0[-1]) == 0):
        return None
    # records must be N-free for the periodic validity arithmetic; one
    # vectorized probe over the chunk's written region
    w = int(rs[-1]) + int(rt[-1])
    if (packed.codes[:w] >= 4).sum() != m - 1:
        return None
    return (R, w)


def pack_chunk_planes(packed, device):
    """Pack ONE flat code chunk (a PackedChunk with record metadata) and
    upload it for a lookup step: returns the `countstep.extract`
    argument with one row, ("periodic", (plo, phi, wvec), L, R) for the
    fixed-length-read layout (2 bits a base on the wire, periodicity
    read off the record metadata) or ("planes", (plo, phi, pnn), L)
    otherwise (3 bits a base).  A chunk of the native reader brings its
    planes (`planes`), which are uploaded as they are."""
    codes = packed.codes
    pl = getattr(packed, "planes", None)
    per = detect_periodic_meta(packed)
    L = codes.shape[0]
    if per is not None:
        R, w = per
        plo, phi = pl[:2] if pl is not None else pack_planes2(codes)
        wvec = torch.tensor([w], dtype=torch.int32, device=device)
        return ("periodic", (u32_to_torch(plo, device),
                             u32_to_torch(phi, device), wvec), L, R)
    return ("planes", tuple(u32_to_torch(p, device)
                            for p in (pl or pack_planes(codes))), L)


class PackedChunk:
    """A fixed-size flat code buffer plus provenance.

    Meta levels (with_meta): False = codes only; "records" = per-record
    piece arrays rec_* (gid, full length, first cell, source offset of
    that cell, base count in this chunk) + names/lens, no per-position
    arrays; True = additionally per-position seq_id/pos."""

    __slots__ = ("codes", "seq_id", "pos", "n_bases", "seq_names",
                 "seq_lens", "rec_gid", "rec_len", "rec_start",
                 "rec_off0", "rec_take", "_recs")

    def __init__(self, chunk_size, full_meta=True):
        self.codes = np.full(chunk_size, 4, np.uint8)
        # per chunk position: global sequence index (-1 = separator/pad) and
        # base offset within that sequence
        if full_meta:
            self.seq_id = np.full(chunk_size, -1, np.int32)
            self.pos = np.zeros(chunk_size, np.int32)
        else:
            self.seq_id = None
            self.pos = None
        self.n_bases = 0
        self.seq_names = {}   # global seq index -> name (only ids in chunk)
        self.seq_lens = {}    # global seq index -> full length
        self.rec_gid = self.rec_len = self.rec_start = None
        self.rec_off0 = self.rec_take = None
        self._recs = []       # (gid, len, start, off0, take) while packing

    def _finish_recs(self):
        m = len(self._recs)
        a = np.array(self._recs, np.int64).reshape(m, 5)
        (self.rec_gid, self.rec_len, self.rec_start, self.rec_off0,
         self.rec_take) = (a[:, j].copy() for j in range(5))


def pack_records(records, chunk_size, k, start_index=0, with_meta=True):
    """Pack an iterable of FastxRecords into PackedChunks (generator).

    with_meta: False / "records" / True (see PackedChunk)."""
    if chunk_size <= k:
        raise ValueError("chunk_size must exceed k")
    full = with_meta is True
    any_meta = bool(with_meta)
    cur = PackedChunk(chunk_size, full_meta=full)
    w = 0

    def register(c, gi, rec, L, w, off):
        if not any_meta:
            return
        c.seq_names[gi] = rec.name
        c.seq_lens[gi] = L
        c._recs.append([gi, L, w, off, 0])

    def flush(c):
        if any_meta:
            c._finish_recs()
        return c

    for idx, rec in enumerate(records):
        gi = start_index + idx
        codes = rec.codes
        L = len(codes)
        off = 0
        register(cur, gi, rec, L, w, off)
        while off < L:
            if chunk_size - w < k:  # no room for a single window
                yield flush(cur)
                cur = PackedChunk(chunk_size, full_meta=full)
                w = 0
                register(cur, gi, rec, L, w, off)
            take = min(L - off, chunk_size - w)
            cur.codes[w:w + take] = codes[off:off + take]
            if any_meta:
                cur._recs[-1][2:] = [w, off, take]
            if full:
                cur.seq_id[w:w + take] = gi
                cur.pos[w:w + take] = np.arange(off, off + take, dtype=np.int32)
            cur.n_bases += take
            w += take
            off += take
            if off < L:
                off -= (k - 1)  # halo: continuation re-reads k-1 bases
                yield flush(cur)
                cur = PackedChunk(chunk_size, full_meta=full)
                w = 0
                register(cur, gi, rec, L, w, off)
        w += 1  # one separator cell (already code 4) between sequences

    if cur.n_bases > 0:
        yield flush(cur)
