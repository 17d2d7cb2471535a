"""The sorted-array count table in plain torch: the port's sort-merge
engine and the semantic mirror the merge-reduce kernel is held to.

Port of `yak_tpu/ops/sorttable.py` (make_table, grow, hist,
compact_where, and merge_batch in its ADD and OR modes).  The table is
a sorted dense array of (key, count) with a live size; a batch merge is
a concat of the table and batch keys (invalid lanes INT64_MAX), one
`torch.sort` whose indices tell table lanes from batch lanes, per-run
sums and table presence read off a prefix sum at run ends, and a
compaction sort of the survivors.  Semantics are the reference's
(htab.c): saturating 10-bit counts, create vs increment-only, and the
OR of the load modes' flags (htab.c:449-470) in OR mode.

Keys are any int64 below INT64_MAX: k <= 31 hashes as they are, k >= 32
hashes wide-encoded (`ops/keys.encode_wide`), whose int64 order is their
unsigned order; the engine needs nothing else to serve both.

All shapes are data-independent, so no step waits on the device.
"""

import torch

from yak_tpu_torch import YAK_COUNTER_BITS, YAK_MAX_COUNT
from yak_tpu_torch.ops.keys import INT64_MAX

# field split of the combined i64 prefix: bits [0,40) value sum,
# bits [40,63) table-entry count
_FSHIFT = 40
_FMASK = (1 << 40) - 1

ADD = 0  # cnt = min(table + sum(batch), max_count)
OR = 1   # cnt = table | batch (batch keys must be unique within a call)


def make_table(cap, device):
    """Empty table: (keys int64 [cap], cnt int32 [cap], size int32 [])."""
    return (torch.zeros(cap, dtype=torch.int64, device=device),
            torch.full((cap,), -1, dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def grow(tkeys, tcnt, size, new_cap):
    """Pad-extend to a bigger capacity (no rehash needed)."""
    cap = tkeys.shape[0]
    if new_cap < cap:
        raise ValueError(f"grow: {new_cap} < current capacity {cap}")
    dev = tkeys.device
    return (torch.cat([tkeys, torch.zeros(new_cap - cap, dtype=torch.int64,
                                          device=dev)]),
            torch.cat([tcnt, torch.full((new_cap - cap,), -1,
                                        dtype=torch.int32, device=dev)]),
            size)


def _shift1(x, fill):
    """x shifted right by one lane, `fill` in lane 0."""
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device),
                      x[:-1]])


def merge_batch(tkeys, tcnt, size, h, add, valid, create=True,
                max_count=YAK_MAX_COUNT, mode=ADD):
    """Merge a batch into the table.  ADD mode: cnt = min(table +
    sum(batch adds), max_count), the batch may repeat keys.  OR mode:
    cnt = table | batch value, the batch keys unique (the restore into
    an existing table, whose `.yak` files hold unique hashes).

    h int64 [B] keys (< INT64_MAX), add int [B] weights >= 0, valid
    bool [B].
    Returns (tkeys, tcnt, size, n_new, overflow): n_new = newly created
    distinct keys; overflow True if the merged size exceeded cap (the
    result is then truncated and the caller must grow and retry)."""
    cap = tkeys.shape[0]
    keys, cnt, new_size, n_new = merge_batch_core(
        tkeys, tcnt, size, h, add, valid, create, max_count, mode)
    return keys, cnt, torch.clamp(new_size, max=cap), n_new, new_size > cap


def merge_batch_core(tkeys, tcnt, size, h, add, valid, create=True,
                     max_count=YAK_MAX_COUNT, mode=ADD):
    """merge_batch before its size clamp: returns (tkeys, tcnt, new_size,
    n_new) with new_size counted before truncation to cap, so that
    new_size > cap is the overflow flag.  This is also the plain version
    the merge-reduce kernel is held to (ops/merge.py)."""
    cap = tkeys.shape[0]
    dev = tkeys.device
    lane = torch.arange(cap, dtype=torch.int64, device=dev)
    pt = torch.where(lane < size.to(torch.int64), tkeys, INT64_MAX)
    pb = torch.where(valid, h, INT64_MAX)
    # a lane's source is its index: table lanes come first in the concat
    key, order = torch.sort(torch.cat([pt, pb]))
    V = torch.cat([tcnt, add.to(torch.int32)])[order]
    real = key != INT64_MAX
    is_table = real & (order < cap)

    n = key.shape[0]
    newkey = torch.ones(n, dtype=torch.bool, device=dev)
    newkey[1:] = key[1:] != key[:-1]
    nxt_new = torch.cat([newkey[1:], newkey.new_ones(1)])
    nxt_real = torch.cat([real[1:], real.new_zeros(1)])
    end = real & (nxt_new | ~nxt_real)

    W = torch.where(real, V.to(torch.int64), 0) | (
        is_table.to(torch.int64) << _FSHIFT)
    P = torch.cumsum(W, 0)
    Q = torch.cummax(torch.where(end, P, 0), 0).values
    tot = P - _shift1(Q, 0)
    has_table = (tot >> _FSHIFT) > 0
    if mode == ADD:
        outV = torch.clamp(tot & _FMASK, max=max_count).to(torch.int32)
    else:  # OR: a run holds at most one table and one batch lane
        outV = torch.where(newkey, V, _shift1(V, 0) | V)

    if create:
        keep = end
        n_new = (end & ~has_table).sum()
    else:
        keep = end & has_table
        n_new = torch.zeros((), dtype=torch.int64, device=dev)
    new_size = keep.sum().to(torch.int32)

    # compaction: kept lanes first, ascending key order preserved
    Kc, order = torch.sort(torch.where(keep, key, INT64_MAX))
    Vc = outV[order]
    return Kc[:cap].contiguous(), Vc[:cap].contiguous(), new_size, n_new


def hist(tcnt, size):
    """1024-bin histogram over live entries (int64)."""
    lane = torch.arange(tcnt.shape[0], device=tcnt.device)
    c = torch.where(lane < size, tcnt & YAK_MAX_COUNT,
                    1 << YAK_COUNTER_BITS)
    return torch.bincount(c.to(torch.int64),
                          minlength=(1 << YAK_COUNTER_BITS) + 1)[
        :1 << YAK_COUNTER_BITS]


def compact_where(tkeys, tcnt, size, keep):
    """Keep live entries where `keep`; returns (tkeys, tcnt, new_size).
    The ascending key order is preserved (used by shrink)."""
    lane = torch.arange(tkeys.shape[0], device=tkeys.device)
    k = keep & (lane < size)
    Kc, order = torch.sort(torch.where(k, tkeys, INT64_MAX))
    return Kc, tcnt[order], k.sum().to(torch.int32)
