"""Blocked Bloom prefilter of the `-b` count's first pass, in plain torch.

Port of `yak_tpu/ops/bloom.py`, with its serial-exact rank gate (the
gate of `-X`, see `bloom_insert`).  Reference semantics
(bbf.c:25-42, one filter per `pre`-bit shard, htab.c:23-27): for the
shard-stripped hash x = h >> pre,

  block   = x & (2^(n_shift-pre-9) - 1)        (512-bit blocks)
  h1      = (x >> block_bits) & 511             (first probe)
  h2      = (x >> (n_shift-pre)) & 511          (stride; +1 if h2 & 31 == 0)
  probes  = h1, h1+h2, h1+2*h2, ... (mod 512), n_hashes of them

and a k-mer enters the count table only when all n_hashes bits were
already set (htab.c:63-64).

The filter is the whole 2^n_shift-bit array laid out shard-major, as
int32 words holding the u32 bit patterns; on a mesh of 2^s shards each
shard holds the slice of its own `pre`-bit shards, 2^(n_shift - s)
bits (`shard_shift` = s), whose probe positions `probe_geom` gives in
the slice, so the serial-exact gate's packed positions are s bits
narrower.  Hashes are int64 bit patterns
of u64 values, so every right shift of a full hash is the logical `srl`,
and every word and block index is int64 (at -b37 the filter has 2^32
words).  A batch of unique keys (the `active` lanes) is inserted as:

  1. one 64-byte block gather per key (all its probes land in one
     block), counting the probed bits already set plus the bits an
     earlier probe of the same key set (bbf.c:37-39): every key sees
     the filter as it was before the batch;
  2. the probed bit positions sorted, duplicates dropped, and each
     word's bit masks summed: the bits are unique, so the sum is the OR
     (torch has no scatter-OR); sums run in int64 and keep their low 32
     bits.  The dense tail (at most 2^22 words) takes each word's sum as
     a prefix-sum difference and builds a new filter; the sparse tail
     writes the sums of the run-end lanes into the filter in place.

The serial-exact gate (`rank` given): the reference inserts a shard
buffer's keys one at a time (htab.c:57-70), so a key's gate also sees
the bits of the keys before it in the same batch.  With each active
key's serial first-occurrence rank, the probes are sorted by (bit
position, rank, probe): the first lane of a position's run is its
earliest setter, and a probe was not yet visible at its key's first
occurrence exactly when it needed its bit (not set before the batch nor
by an earlier probe of its key) and its key is that earliest setter.
Only n_before changes; the filter update is the one above.

The count's one-fold-late overflow replay must see the filter as it was
before the fold, so every update returns an undo record: the pre-update
filter itself where the update built a new one, or (word index, old
word) for the lanes an in-place update touched; `rollback` applies it.
"""

import torch

from yak_tpu_torch import YAK_BLK_SHIFT
from yak_tpu_torch.ops import scan
from yak_tpu_torch.ops.keys import INT64_MAX, i32_bits, srl
from yak_tpu_torch.ops.sorttable import last_set_lane

BLK_MASK = (1 << YAK_BLK_SHIFT) - 1          # 511
BLK_WORDS = 1 << (YAK_BLK_SHIFT - 5)         # 16 words a block
DENSE_WORDS = 1 << 22                        # dense tail up to 16 MiB


def make_bloom(n_shift, device):
    """An empty filter of 2^n_shift bits (n_shift >= 9): int32 words (a
    mesh shard's slice of a 2^b-bit filter is make_bloom(b -
    shard_shift))."""
    if n_shift < YAK_BLK_SHIFT:
        raise ValueError(f"Bloom filter of 2^{n_shift} bits: at least one "
                         f"512-bit block (n_shift >= 9) is needed")
    return torch.zeros(1 << (n_shift - 5), dtype=torch.int32, device=device)


def probe_geom(h, *, pre, n_shift, n_hashes, shard_shift=0):
    """Probe geometry of yak_bf_insert (bbf.c:25-33) for int64 hashes:
    each key's block bit offset `base` in its filter and its n_hashes
    in-block bit positions `zs` (each < 512), all int64.  shard_shift:
    the filter is a mesh shard's slice (see `bloom_insert`), so the
    shard's filter is indexed by shard >> shard_shift."""
    ns_ = n_shift - pre
    xbits = ns_ - YAK_BLK_SHIFT
    shard = (h & ((1 << pre) - 1)) >> shard_shift
    x = srl(h, pre)                            # < 2^63: `>>` is logical
    y = x & ((1 << xbits) - 1)
    h1 = (x >> xbits) & BLK_MASK
    h2 = (x >> ns_) & BLK_MASK
    h2 = torch.where((h2 & 31) == 0, (h2 + 1) & BLK_MASK, h2)
    base = (shard << ns_) | (y << YAK_BLK_SHIFT)
    zs, z = [], h1
    for _ in range(n_hashes):
        zs.append(z)
        z = (z + h2) & BLK_MASK
    return base, zs


def exact_gate_fits(n_shift, n_hashes, rank_bound, shard_shift=0):
    """Whether the serial-exact gate's packed (position, rank, probe) sort
    key of a batch with ranks below rank_bound fits below 2^63; a slice
    of a 2^n_shift-bit filter (shard_shift) has positions of
    n_shift - shard_shift bits."""
    rank_bits = max(1, int(max(rank_bound - 1, 1)).bit_length())
    return n_hashes <= 8 and n_shift - shard_shift + rank_bits + 3 < 64


def probe_seen(bf, base, zs):
    """Per probe, whether its bit is set in `bf` or by an earlier probe of
    the same key (int64 0/1 [n] each).  One 64-byte block gather per key
    replaces n_hashes word gathers."""
    blocks = bf.reshape(-1, BLK_WORDS)
    rows = blocks[(base >> YAK_BLK_SHIFT).clamp(0, blocks.shape[0] - 1)]
    out = []
    for i, zi in enumerate(zs):
        word = rows.gather(1, (zi >> 5)[:, None])[:, 0].to(torch.int64)
        seen = (word >> (zi & 31)) & 1
        for zj in zs[:i]:
            seen = seen | (zj == zi).to(torch.int64)
        out.append(seen)
    return out


def probe_count(bf, base, zs, active):
    """Per active key, how many of its probed bits are set in `bf` or by
    an earlier probe of the same key (int32; 0 for inactive lanes)."""
    n_before = torch.zeros(base.shape, dtype=torch.int32, device=bf.device)
    for seen in probe_seen(bf, base, zs):
        n_before += torch.where(active, seen, 0).to(torch.int32)
    return n_before


def serial_count(bf, base, zs, active, rank, rank_bound):
    """n_before under the reference's serial order (the rank branch of
    yak_tpu's bloom_insert): `rank` int [n] is each active key's serial
    first-occurrence position, distinct and below rank_bound.  The
    inactive lanes sort last as INT64_MAX; the active packed keys are
    below 2^63 (exact_gate_fits), so signed order is their order.  Each
    run's head is found by `sorttable.last_set_lane`, not a
    torch.cummax, which scans in one block on the card."""
    nh, n = len(zs), base.shape[0]
    rank_bits = max(1, int(max(rank_bound - 1, 1)).bit_length())
    sh = rank_bits + 3
    r = rank.to(torch.int64).clamp(0, rank_bound - 1) << 3
    packed = torch.stack([torch.where(active, ((base + z) << sh) | r | i,
                                      INT64_MAX)
                          for i, z in enumerate(zs)]).reshape(-1)
    need = torch.stack([active & (s == 0)
                        for s in probe_seen(bf, base, zs)]).reshape(-1)
    ps, perm = torch.sort(packed)
    pos = ps >> sh
    head = last_set_lane(pos != _shift_in(pos, -1)).to(torch.int64)
    rk = (ps >> 3) & ((1 << rank_bits) - 1)
    bad = (ps != INT64_MAX) & need[perm] & ~(rk > rk[head])
    nbad = torch.zeros(nh * n, dtype=torch.int32, device=bf.device)
    nbad.scatter_(0, perm, bad.to(torch.int32))
    return torch.where(active, nh - nbad.reshape(nh, n).sum(0), 0) \
        .to(torch.int32)


def _shift_in(x, fill):
    """x moved one lane later, `fill` in lane 0."""
    return torch.cat([x.new_full((1,), fill), x[:-1]])


def bloom_insert(bf, h, active, rank=None, *, pre, n_shift, n_hashes,
                 rank_bound=0, shard_shift=0, kernel=False):
    """Query-and-set the active lanes of `h` (unique hashes).

    Returns (bf', n_before, undo): n_before[i] is the number of probed
    bits already set (yak_bf_insert's return; the key enters the table
    iff n_before == n_hashes).  Up to 2^22 words bf' is a new filter and
    undo is `bf`, untouched; above, bf is updated in place, bf' is bf,
    and undo holds the touched words' old values (see `rollback`).

    rank (optional): each active key's serial first-occurrence position,
    below rank_bound; when given and the packed key fits
    (exact_gate_fits), n_before follows the reference's serial order
    (`serial_count`), else every key sees the filter as it was before
    the batch, as in yak_tpu.

    shard_shift (a mesh of 2^shard_shift shards, shard d owning the
    hashes with h & (2^shard_shift - 1) == d): `bf` is shard d's slice
    of 2^(n_shift - shard_shift) bits, which holds the filters of its
    own `pre`-bit shards in order, each bit for bit the same as in the
    one-device filter (the per-shard filters of htab.c:23-27 dealt to
    the mesh's shards, yak_tpu/ops/bloom.py:139-160).

    kernel: the sparse update finds its word runs' heads by the scan
    kernel (`scan.last_set_lane`), as the default engine's gate posts
    ask; else by library calls alone (`sorttable.last_set_lane`), as the
    sort-merge engines' gate does."""
    base, zs = probe_geom(h, pre=pre, n_shift=n_shift, n_hashes=n_hashes,
                          shard_shift=shard_shift)
    if rank is not None and exact_gate_fits(n_shift, n_hashes, rank_bound,
                                            shard_shift):
        n_before = serial_count(bf, base, zs, active, rank, rank_bound)
    else:
        n_before = probe_count(bf, base, zs, active)
    nwords = bf.shape[0]
    pos = torch.stack([base + z for z in zs]).reshape(-1)
    act = active.repeat(len(zs))
    p = torch.sort(torch.where(act, pos, INT64_MAX)).values
    valid = p != INT64_MAX
    uniq = valid & (p != _shift_in(p, -1))
    w = torch.where(valid, p >> 5, nwords)
    m = torch.where(uniq, torch.ones_like(p) << (p & 31), 0)
    csum0 = torch.cat([m.new_zeros(1), torch.cumsum(m, 0)])
    if nwords <= DENSE_WORDS:
        bounds = torch.searchsorted(
            w, torch.arange(nwords + 1, dtype=torch.int64, device=bf.device))
        mask = csum0[bounds[1:]] - csum0[bounds[:-1]]
        return bf | i32_bits(mask), n_before, bf
    # sparse: one write per touched word, at the last lane of its run
    word_start = valid & (w != _shift_in(w, -1))
    nxt = torch.cat([w[1:], w.new_full((1,), nwords)])
    word_end = valid & (w != nxt)
    # each lane's word run's first lane (lane 0 where no run has begun)
    heads = scan.last_set_lane if kernel else last_set_lane
    start = heads(word_start).clamp_(min=0)
    run_mask = i32_bits(csum0[1:] - csum0.index_select(0, start))
    idx = torch.where(word_end, w, 0)
    old = bf[idx]
    # the run's bits not yet set: adding them is OR-ing them
    bf.scatter_add_(0, idx, torch.where(word_end, run_mask & ~old, 0))
    return bf, n_before, (idx, old)


def rollback(bf, undo):
    """The filter as it was before the update that returned `undo`."""
    if isinstance(undo, tuple):
        idx, old = undo
        bf.index_put_((idx,), old)
        return bf
    return undo
