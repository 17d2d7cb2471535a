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
from yak_tpu_torch.ops.keys import INT64_MAX, SIGN, i32_bits

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
    the merge-reduce kernel is held to (ops/merge.py).  It is the merged
    stream of `merge_stream` closed up by a compaction sort; the drop
    mark is kept as a mask here, as wide keys use the sign bit."""
    cap = tkeys.shape[0]
    key, order = torch.sort(_merge_keys(tkeys, size, h, valid))
    outV, keep, new_size, n_new = _merge_runs(key, order, tcnt, add, create,
                                              max_count, mode)
    # compaction: kept lanes first, ascending key order preserved
    Kc, order = torch.sort(torch.where(keep, key, INT64_MAX))
    Vc = outV[order]
    return Kc[:cap].contiguous(), Vc[:cap].contiguous(), new_size, n_new


def merge_stream(tkeys, tcnt, size, h, add, valid, create=True,
                 max_count=YAK_MAX_COUNT, mode=ADD):
    """The merged stream before its compaction (merge_batch_impl with
    compact=False, yak_tpu/ops/sorttable.py:154-159), for keys below
    2^63 that are non-negative (k <= 31 hashes).

    Returns (khi, klo, outV int32 [cap + B], size, n_new, overflow): the
    concat of the live table and the valid batch, sorted, each key run's
    total at its last lane; a lane is kept where it ends a run that
    survives (create, or the key was in the table), and every other lane
    carries `key | 1 << 63`, split into khi = key >> 32 (arithmetic, so
    khi < 0 exactly where the lane is dropped: the compaction kernel's
    mark) and klo = the low 32 bits.  The kept lanes stay in ascending
    key order; `compact.compact` closes them up.  Counts at dropped
    lanes are partial sums and pad lanes carry INT64_MAX: neither is
    defined.  size is min(new_size, cap), overflow new_size > cap."""
    cap = tkeys.shape[0]
    key, order = torch.sort(_merge_keys(tkeys, size, h, valid))
    outV, keep, new_size, n_new = _merge_runs(key, order, tcnt, add, create,
                                              max_count, mode)
    kc = torch.where(keep, key, key | SIGN)
    return ((kc >> 32).to(torch.int32), i32_bits(kc), outV,
            torch.clamp(new_size, max=cap), n_new, new_size > cap)


def _merge_keys(tkeys, size, h, valid):
    """The table's live keys then the batch's valid ones, INT64_MAX
    elsewhere: a lane's source is its index in this concat."""
    lane = torch.arange(tkeys.shape[0], dtype=torch.int64,
                        device=tkeys.device)
    return torch.cat([torch.where(lane < size.to(torch.int64), tkeys,
                                  INT64_MAX),
                      torch.where(valid, h, INT64_MAX)])


def _merge_runs(key, order, tcnt, add, create, max_count, mode):
    """The run reduction of a sorted concat (`_merge_keys` and its sort
    permutation `order`): each run's total at its last lane, the lanes
    kept, the survivors' count and the created keys'.  The prefix just
    before each run is the prefix sum at the previous run end, read by
    `last_set_lane`, where the JAX package takes a cummax (the prefix
    is nondecreasing, so the value at the last run end is the same)."""
    cap = tcnt.shape[0]
    dev = key.device
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
    j = last_set_lane(end)
    Q = torch.where(j >= 0, P[j.clamp(min=0).to(torch.int64)], 0)
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
    return outV, keep, keep.sum().to(torch.int32), n_new


def last_set_lane(mask):
    """For each lane i, the last lane j <= i where `mask` is set, else -1
    (int32 [M]): `torch.cummax(torch.where(mask, lane, -1))`, which
    the JAX package computes (`jax.lax.cummax`), without torch.cummax,
    whose CUDA kernel scans a 1-D tensor in one block (22.3 ms against
    0.54 ms at 8,388,578 lanes on an H100, tools/trio_post_probe.py).
    The set lanes are numbered by a cumsum, each writes its lane at its
    number (the other lanes write to 1024 spare slots that nothing
    reads), and each lane reads back the lane of its number.  On the CPU,
    whose cummax is one linear pass (2-3x faster than the scatter at
    1.2 M and 29 M lanes), it is torch.cummax.  Library calls alone: the
    default engine's gate posts take the hand-written kernel
    (`ops/scan.last_set_lane`) instead."""
    if mask.device.type == "cpu":
        lane = torch.arange(mask.numel(), dtype=torch.int32)
        return torch.cummax(torch.where(mask, lane, -1), 0).values
    return last_set_lane_scatter(mask)


def last_set_lane_scatter(mask):
    """last_set_lane by the scatter, on any device."""
    n = mask.numel()
    lane = torch.arange(n, dtype=torch.int32, device=mask.device)
    num = torch.cumsum(mask, 0, dtype=torch.int32)
    slot = torch.where(mask, num, n + 1 + (lane & 1023)).to(torch.int64)
    pos = torch.full((n + 1025,), -1, dtype=torch.int32, device=mask.device)
    pos.scatter_(0, slot, lane)
    return pos[num.to(torch.int64)]


def lookup(tkeys, tcnt, size, qkeys):
    """The sorted join (yak_tpu/ops/sorttable.py:180-262: lookup_qpacked
    for k <= 31, lookup_impl for wide keys; both are one algorithm on
    the port's int64 keys): each query's table count, -1 where absent
    or invalid, in the queries' lane order (int32 [B]).  qkeys int64 [B]
    are in the table's encoding (wide-encoded for k >= 32), INT64_MAX
    for invalid lanes.

    The live table and the queries are sorted together, stably, so a
    table lane comes before the queries of its key; each lane's last
    table lane at or before it (`last_set_lane`, the JAX package's
    cummax of run_id << 11 | count + 1) is a hit where its key is the
    query's.  The results go back to the queries' lanes by one scatter
    (the JAX package's restoring sort); table lanes write to a spare
    slot that is cut off."""
    cap, B = tkeys.shape[0], qkeys.shape[0]
    key, order = torch.sort(_merge_keys(tkeys, size, qkeys,
                                        qkeys != INT64_MAX), stable=True)
    is_q = order >= cap
    j = last_set_lane(~is_q & (key != INT64_MAX)).to(torch.int64)
    jc = j.clamp(min=0)
    hit = is_q & (key != INT64_MAX) & (j >= 0) & (key[jc] == key)
    cnt = tcnt[order[jc].clamp(max=cap - 1)]
    res = torch.where(hit, cnt, -1).to(torch.int32)
    out = torch.empty(B + 1, dtype=torch.int32, device=tkeys.device)
    out.scatter_(0, torch.where(is_q, order - cap, B), res)
    return out[:B]


def dedup(keys, rank=None, with_rank=False):
    """Sort a key batch and coalesce duplicates (sorttable.dedup,
    yak_tpu/ops/sorttable.py:302-348), for the Bloom gate of the
    sort-merge engines, which needs each key's multiplicity before the
    table merge.  keys int64 [n], INT64_MAX for invalid lanes (which
    sort last).

    Returns (hs, starts, mult[, rk]): the sorted keys, the run-start
    mask of the valid runs, and at each start lane the run's length
    (the distance to the next start, the last run's to the valid
    count).  With with_rank, rk at a start lane is the run's least
    rank: a lane's serial rank is `rank` (int [n]) where given, else
    the lane itself, and the sort is stable on it (the JAX package
    sorts the rank as a second key)."""
    n = keys.numel()
    dev = keys.device
    if not with_rank:
        hs, rk = torch.sort(keys).values, None
    elif rank is None:
        hs, rk = torch.sort(keys, stable=True)
    else:
        by_rank = torch.sort(rank, stable=True).indices
        hs, o = torch.sort(keys[by_rank], stable=True)
        rk = rank[by_rank][o]
    vs = hs != INT64_MAX
    starts = vs.clone()
    starts[1:] &= hs[1:] != hs[:-1]
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    # the first start at or after each lane, from the last set lane of
    # the reversed mask (the JAX package's reverse cummin)
    back = last_set_lane(starts.flip(0)).flip(0).to(torch.int64)
    first_from = torch.where(back >= 0, n - 1 - back, n)
    nxt = torch.cat([first_from[1:], first_from.new_full((1,), n)])
    mult = (torch.minimum(nxt, vs.sum()) - lane).to(torch.int32)
    if not with_rank:
        return hs, starts, mult
    return hs, starts, mult, rk


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
