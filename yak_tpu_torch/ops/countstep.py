"""The device steps: the count fold (packed planes -> k-mer hashes ->
sorted batch -> [Bloom gate ->] merge-reduce into the table) and the
lookup steps of qv, chkerr, triobin, trioeval and sexchr (packed
planes -> hashes -> sorted queries -> merge-JOIN -> per-chunk
reduction), and the sort + JOIN of raw hash batches (`lookup_keys`:
inspect, `KmerTable.lookup_hashes`).

Port of the default count engine of `yak_tpu/ops/countstep.py`
(`get_count_step_pmerge{,_planes}`, `get_count_wide_step{,_planes}`,
`get_count_bloom_step{,_planes}`, `_pmerge_prep_core`,
`finalize_pmerge`, `pmerge_overflow`), of its Bloom gate posts
(`get_bloom_gate_post`, `_gate_sent_a`, `_gate_sent_b`,
`gate_sent_fits`, `run_bloom_gate_post`) and of the serial-exact gate
of -X (`_gate_batch(exact=True)`, `_serial_rank`).  The batch sort is
`torch.sort`, as the JAX package's is `lax.sort` in XLA
(countstep.py:215-239, 387-425); the merge is the hand-written kernel
(`ops/merge.py`).  The batch travels as plain ascending int64 keys with
INT64_MAX for invalid lanes, k >= 32 hashes wide-encoded
(`ops/keys.encode_wide`): the TPU prep's complement trick, stream bit
and u32 planes exist for the TPU kernel only.

A fold's engine is `fold_engine`'s (yak_tpu/table.py::_pallas_mode,
read at each fold): the default above ("pmerge"), psort, or the
sort-merge engines of `get_count_step` (`sortmerge_step`: the
extraction, `gate_batch` (`_gate_batch` over `sorttable.dedup`) and
`sorttable.merge_batch`, "xla", all plain torch, or
`sorttable.merge_stream` closed up by the compaction kernel and
`finalize_compacted`, "compact").  The lookups JOIN through the kernel
unless `join_enabled` says no (YAK_TPU_JOIN=0, YAK_TPU_PALLAS=0,
`kernels_enabled`), when they take the sorted join
(`sorttable.lookup`); the markers follow `marker_step`.

The psort engine (`psort_enabled`, opt-in as in the JAX package) runs
the batch sorts through the hand-written sort kernel (`ops/sort.py`)
instead: the count fold's batch sort (`get_count_presort_step`, the
psort branch of `yak_tpu/table.py::_run_step`, where the gated fold
takes the plain gate post), the lookups' query sort
(`plookup_presort`, `_join_psort_dispatch`), the qv post's region-key
sort (`get_qv_post_psort_mid`) and chkerr's marker sort in place of the
compaction (`get_chkerr_psort_mid`, `run_marker_psort`).

The gate posts run on the sorted batch, where equal keys are adjacent:
each key run is probed once at its last lane, which carries the run's
add weight (the run length, less one where the key's probed bits were
not all set: its first sighting feeds the filter, not the table), and
the weighted merge drops the runs of weight 0 that the table lacks.

The step never writes into its inputs, so the caller keeps the pre-step
table and can replay the fold after growing it (`table.KmerTable`).

Each phase of a fold or a lookup is a span (`spans.py`: `fold.extract`,
`fold.sort`, `fold.gate`, `fold.merge`, `fold.compact`, `fold.finalize`,
`lookup.extract`, `lookup.sort`, `lookup.join`, and `gate.post` inside
`run_bloom_gate_post`), whose end calls the caller's phase hook.

The lookup steps port `run_join_lookup` with `get_qv_join_pre`, the qv
reduction (`_qv_chunk_stats`, `_qv_fold_step`, `_qv_reduce`,
`_qv_ek_markers`, `get_qv_join_post`), the chkerr marker mid with its
compaction (`get_chkerr_mark_mid`, `run_mark_compact`), triobin's
reductions and -p markers (`_triobin_reduce`, `get_triobin_join_post`,
`get_triobin_psort_mid`) and trioeval's run markers (`_te_emit`,
`get_trioeval_mark_mid`, `get_trioeval_psort_mid`) and sexchr's
segment sums (`_sexchr_reduce`, `get_sexchr_join_post`,
`get_sexchr_psort_mid`), and qv's seg-payload post
(`get_qv_join_pre_seg`, `get_qv_join_post_seg` and their helpers:
`qv_lookup_seg`, `qv_join_post_seg`).  A k >= 32 lookup
goes through the same JOIN, its queries wide-encoded.  The JOIN writes
each query's value at its original lane, so `plookup_post`'s order
restore, `join_restore_vals` and `qv_psort_pad` have no counterpart
here.  The reductions are XLA code in the JAX package and plain torch
here; the compaction is the hand-written kernel (`ops/compact.py`).  No
step reads a value back to the host.
"""

import os

import torch

from yak_tpu_torch import YAK_MAX_COUNT, spans
from yak_tpu_torch.ops import bloom, compact, merge, sort
from yak_tpu_torch.ops import sorttable as st
from yak_tpu_torch.ops.keys import (INT64_MAX, U32_MASK, decode_wide,
                                    encode_wide, i32_bits)
from yak_tpu_torch.ops.kmers import extract_from_planes, extract_periodic
from yak_tpu_torch.ops.sorttable import last_set_lane

MARK_DROP = -(1 << 31)       # khi of a lane the compaction drops (bit 31)
INT32_MAX = (1 << 31) - 1


def kernels_enabled():
    """YAK_TPU_PALLAS (pallas_compact.enabled): 0, false or no sends
    every site that consults it to its sort path (the sort-merge folds,
    the sorted join, the markers by sort), read at each call.  It is a
    user's choice: nothing else engages those paths."""
    return os.environ.get("YAK_TPU_PALLAS", "1") not in ("0", "false", "no")


def join_enabled():
    """Whether the lookups JOIN through the merge-JOIN kernel
    (countstep.join_enabled): unless YAK_TPU_JOIN=0 or the kernels are
    off, in which case they take the sorted join (`sorttable.lookup`).
    The JAX package never JOINs k >= 32 keys; the port's JOIN takes
    them wide-encoded, so the switch has no k."""
    return kernels_enabled() and os.environ.get("YAK_TPU_JOIN", "1") != "0"


def mark_compact_enabled():
    """Whether chkerr's, trioeval's and triobin -p's markers are taken by
    the compaction kernel: where the JOIN runs, unless
    YAK_TPU_MARK_COMPACT=0 (yak_tpu/models/chkerr.py:81, trio.py:654);
    else by one torch.sort (`run_marker_sort`, `run_diff_sort`), as the
    JAX package's non-JOIN steps sort them."""
    return (join_enabled()
            and os.environ.get("YAK_TPU_MARK_COMPACT", "1") != "0")


def psort_enabled():
    """Whether a lookup run (qv, chkerr, triobin, trioeval, inspect,
    sexchr) sorts through the sort kernel: YAK_TPU_PSORT=1 where the
    JOIN runs, as the JAX package takes its psort branches only under
    its JOIN (countstep.psort_enabled, models/*.py ps_post).  Read at
    each call."""
    return os.environ.get("YAK_TPU_PSORT", "0") == "1" and join_enabled()


def fold_engine(k, gated=False, exact=False):
    """The engine of a count fold (table._pallas_mode,
    yak_tpu/table.py:287-376), read at each call:

      "pmerge"  torch.sort batch sort + the merge-reduce kernel (the
                default), gated by the sentinel or plain gate post;
      "psort"   the batch sort through the sort kernel;
      "compact" the sort-merge without its compaction sort, the merged
                stream closed up by the compaction kernel (k <= 31);
      "xla"     the sort-merge in plain torch, no kernel.

    With the precedence of the JAX package: a serial-exact gated fold
    (`exact`, -X) under YAK_TPU_PSORT=1 or YAK_TPU_ENGINE=psort raises;
    YAK_TPU_ENGINE=xla or YAK_TPU_PALLAS=0 takes "xla" at any k; a
    k >= 32 fold takes "xla" when exact, "psort" under YAK_TPU_PSORT=1
    unless YAK_TPU_PSORT_WIDE=0, "pmerge" unless YAK_TPU_WIDE=0, else
    "xla"; a k <= 31 fold takes the engine YAK_TPU_ENGINE=pmerge|compact
    |psort names, else psort under YAK_TPU_PSORT=1 (a gated one unless
    exact or YAK_TPU_PSORT_BLOOM=0), else pmerge.  Any other value of
    YAK_TPU_ENGINE is auto.  The JAX package's interpret hooks and
    Mosaic self-tests have no counterpart."""
    env = os.environ
    forced = env.get("YAK_TPU_ENGINE", "auto")
    on = env.get("YAK_TPU_PSORT", "0") == "1"
    if exact and (on or forced == "psort"):
        raise RuntimeError(
            "-X (byte-exact dump) requires the default engine's "
            "serial-exact Bloom gate; unset YAK_TPU_PSORT/"
            "YAK_TPU_ENGINE=psort or drop -X")
    if forced == "xla" or not kernels_enabled():
        return "xla"
    if k > 31:
        if exact:
            return "xla"
        if on and env.get("YAK_TPU_PSORT_WIDE", "1") != "0":
            return "psort"
        return "pmerge" if env.get("YAK_TPU_WIDE", "1") != "0" else "xla"
    if forced in ("pmerge", "compact", "psort"):
        return forced
    if gated:
        return ("psort" if on and not exact
                and env.get("YAK_TPU_PSORT_BLOOM", "1") != "0" else "pmerge")
    return "psort" if on else "pmerge"


def extract(carg, k):
    """Hashes and validity of one fold's chunks.

    carg is ("periodic", (plo, phi, wvec), L, R) for the fixed-length-read
    layout (2 planes on the wire), ("planes", (plo, phi, pnn), L) for
    the general layout (3 planes), or ("hashes", (h, valid)) for a batch
    whose hashes are already extracted (a mesh shard's routed batch,
    `table.KmerTable.fold_hashes`), returned as it is; such a batch may
    carry a third item, (rank, rank_bound), its lanes' serial ranks for
    the serial-exact gate (`count_step`)."""
    if carg[0] == "hashes":
        return carg[1]
    if carg[0] == "periodic":
        _, (plo, phi, wvec), L, R = carg
        return extract_periodic(plo, phi, wvec, k, L, R)
    _, (plo, phi, pnn), L = carg
    return extract_from_planes(plo, phi, pnn, k, L)


def sort_batch(h, valid, wide=False, psort=False, with_perm=False):
    """Flatten and sort a hash batch ascending; invalid lanes become
    INT64_MAX and sort to the tail.  wide: the hashes are raw k >= 32
    hashes, wide-encoded before the sort.  psort: through the sort
    kernel, else torch.sort.  with_perm (torch.sort only): a stable sort,
    returned with its permutation (int64), whose value at a key run's
    first lane is the run's first lane in the flat batch."""
    keys = torch.where(valid, encode_wide(h) if wide else h, INT64_MAX)
    if psort:
        return sort.sort(keys.reshape(-1))[0]
    if with_perm:
        return torch.sort(keys.reshape(-1), stable=True)
    return torch.sort(keys.reshape(-1)).values


def count_step(carg, k, tkeys, tcnt, size, create, gate=None, hook=None,
               engine="pmerge"):
    """One fold on the engine `fold_engine` names: extract + sort [+ Bloom
    gate post] + merge-reduce + finalize, or on "compact" and "xla"
    `sortmerge_step`.  k >= 32 folds wide-encoded keys.

    gate: None, or (bf, pre, bf_shift, bf_n_hash, exact, shard_shift) to
    run the gated create pass (htab.c:61-70) against the filter bf (a
    mesh shard's slice when shard_shift > 0); exact: through the
    serial-exact gate post (`bloom_gate_exact_post`, -X), whose ranks
    come from a stable torch.sort (fold_engine refuses -X on the psort
    engine, as yak_tpu does), and from the carg's (rank, rank_bound)
    where a hash batch carries them.  The psort engine's batch sort is
    the sort kernel and its gated fold takes the plain gate post
    (yak_tpu/table.py:414-420).

    Returns (keys, cnt, size, n_new, overflow, bf', undo): the new table
    truncated to cap, its live size min(new_size, cap), the created-key
    count and the device overflow flag new_size > cap; with a gate, the
    updated filter and the undo record that `bloom.rollback` turns back
    into the pre-fold filter (else None, None).  `hook`, when given, is
    called with each phase's name as the phase (the span `fold.<name>`)
    is queued."""
    if engine in ("compact", "xla"):
        return sortmerge_step(carg, k, tkeys, tcnt, size, create, gate,
                              hook, engine == "compact")
    psort = engine == "psort"
    wide = k > 31
    exact = gate is not None and gate[4]
    with spans.span("fold.extract", hook):
        h, valid = extract(carg, k)
    with spans.span("fold.sort", hook):
        if exact:
            bkeys, perm = sort_batch(h, valid, wide, with_perm=True)
        else:
            bkeys = sort_batch(h, valid, wide, psort)
    weights = bf = undo = None
    if exact:
        rank, rank_bound = _carried_rank(carg)
        with spans.span("fold.gate", hook):
            weights, bf, undo = bloom_gate_exact_post(
                bkeys, perm, *gate[:4], wide=wide, shard_shift=gate[5],
                rank=rank, rank_bound=rank_bound)
    elif gate is not None:
        post = bloom_gate_post if psort else run_bloom_gate_post
        with spans.span("fold.gate", hook):
            weights, bf, undo = post(bkeys, *gate[:4], wide=wide,
                                     shard_shift=gate[5])
    with spans.span("fold.merge", hook):
        okeys, ocnt, new_size, n_new = merge.merge_reduce(
            tkeys, tcnt, size, bkeys, create, weights=weights, wide=wide)
    with spans.span("fold.finalize", hook):
        out = finalize(okeys, ocnt, new_size, n_new, tkeys.shape[0])
    return out + (bf, undo)


def _carried_rank(carg):
    """(rank, rank_bound) of a hash batch that carries its lanes' serial
    ranks, else (None, None)."""
    return carg[2] if carg[0] == "hashes" and len(carg) > 2 else (None, None)


def sortmerge_step(carg, k, tkeys, tcnt, size, create, gate=None, hook=None,
                   compact_kernel=False):
    """One fold of the sort-merge engines (get_count_step,
    yak_tpu/ops/countstep.py:119-165): extract [+ `gate_batch`] + the
    sort-merge of the table and the batch.  "xla" (compact_kernel
    False) closes the merged stream up by its compaction sort
    (`sorttable.merge_batch`); "compact" takes the stream as it is
    (`sorttable.merge_stream`, k <= 31) and closes it up by the
    compaction kernel (`compact.compact`, which on a CUDA tensor
    launches csrc/compact.cu or raises), then `finalize_compacted`
    (yak_tpu/table.py:471-477).  Arguments and result as count_step;
    the hook's phases are "extract", "gate", "merge", "compact" (the
    compact engine) and "finalize"."""
    wide = k > 31
    with spans.span("fold.extract", hook):
        h, valid = extract(carg, k)
        keys = torch.where(valid, encode_wide(h) if wide else h,
                           INT64_MAX).reshape(-1)
    bf = undo = None
    if gate is not None:
        rank, rank_bound = _carried_rank(carg)
        with spans.span("fold.gate", hook):
            keys, starts, add, bf, undo = gate_batch(
                keys, *gate[:5], wide=wide, shard_shift=gate[5], rank=rank,
                rank_bound=rank_bound)
            valid = starts & (add > 0)
    else:
        valid = keys != INT64_MAX
        add = torch.ones(keys.shape, dtype=torch.int32, device=keys.device)
    cap = tkeys.shape[0]
    if compact_kernel:
        with spans.span("fold.merge", hook):
            khi, klo, v, size2, n_new, ovf = st.merge_stream(
                tkeys, tcnt, size, keys, add, valid, create)
        with spans.span("fold.compact", hook):
            ohi, olo, ov, _n = compact.compact(khi, klo, v)
        with spans.span("fold.finalize", hook):
            okeys, ocnt = finalize_compacted(ohi, olo, ov, cap)
    else:
        with spans.span("fold.merge", hook):
            okeys, ocnt, size2, n_new, ovf = st.merge_batch(
                tkeys, tcnt, size, keys, add, valid, create)
        # merge_batch closed the table up: an empty finalize phase keeps
        # the hook's sequence
        with spans.span("fold.finalize", hook):
            pass
    return okeys, ocnt, size2, n_new, ovf, bf, undo


def finalize_compacted(khi, klo, v, cap):
    """The compacted planes -> table state (keys int64 [cap], cnt int32
    [cap]) (countstep.finalize_compacted): the first cap lanes, khi and
    klo joined back into int64 keys.  Truncation to cap is safe: the
    caller reads the merge's overflow flag."""
    keys = (khi[:cap].to(torch.int64) << 32) | (klo[:cap].to(torch.int64)
                                               & U32_MASK)
    return keys, v[:cap].contiguous()


def gate_batch(keys, bf, pre, bf_shift, bf_n_hash, exact, wide=False,
               shard_shift=0, rank=None, rank_bound=None):
    """Dedup a fold's key batch and run the Bloom create gate
    (_gate_batch, yak_tpu/ops/countstep.py:84-117, htab.c:61-70), as
    the sort-merge engines gate: `sorttable.dedup`, then one
    `bloom.bloom_insert` of the run starts (the raw hash: wide keys are
    decoded first).  The cheap gate sees the filter as it was before
    the fold; the exact one (-X) takes each key's serial rank, the lane
    of its first occurrence in the flat batch (the chunks in order,
    each chunk's windows in base order: `_serial_rank`'s plain base
    position), or the least of `rank` (int [B], below rank_bound) over
    its lanes where a batch carries them.

    Returns (hs, starts, add, bf', undo): the sorted keys, the run
    starts, at each start the run's weight (its length, less one where
    its probed bits were not all set), and bloom_insert's filter and
    undo record; the merge takes valid = starts & (add > 0)."""
    n = keys.numel()
    if exact:
        hs, starts, mult, rk = st.dedup(keys, rank, with_rank=True)
        ranked = dict(rank=rk, rank_bound=rank_bound if rank is not None
                      else n)
    else:
        hs, starts, mult = st.dedup(keys)
        ranked = {}
    bf2, n_before, undo = bloom.bloom_insert(
        bf, decode_wide(hs) if wide else hs, starts, pre=pre,
        n_shift=bf_shift, n_hashes=bf_n_hash, shard_shift=shard_shift,
        **ranked)
    add = torch.where(n_before == bf_n_hash, mult, mult - 1)
    return hs, starts, add.to(torch.int32), bf2, undo


def finalize(okeys, ocnt, new_size, n_new, cap):
    """Merge-reduce outputs -> table state + flags (the port of
    countstep.finalize_pmerge and pmerge_overflow)."""
    return (okeys, ocnt, torch.clamp(new_size, max=cap),
            n_new.to(torch.int64), new_size > cap)


# -- the Bloom gate posts ---------------------------------------------------

def _runs(bkeys):
    """Key runs of a sorted batch: (ends bool [B], mult int32 [B]): the
    last lane of each valid run, and at that lane the run's length."""
    n = bkeys.shape[0]
    newkey = torch.ones(n, dtype=torch.bool, device=bkeys.device)
    newkey[1:] = bkeys[1:] != bkeys[:-1]
    ends = (torch.cat([newkey[1:], newkey.new_ones(1)])
            & (bkeys != INT64_MAX))
    lane = torch.arange(n, dtype=torch.int32, device=bkeys.device)
    start = torch.cummax(torch.where(newkey, lane, 0), 0).values
    return ends, lane - start + 1


def _gate_weights(ends, mult, n_before, bf_n_hash):
    """The weight at each run end: mult when all probed bits were set,
    else mult - 1 (get_bloom_gate_post)."""
    add = torch.where(n_before == bf_n_hash, mult, mult - 1)
    return torch.where(ends, add, 0).to(torch.int32)


def bloom_gate_post(bkeys, bf, pre, bf_shift, bf_n_hash, wide=False,
                    shard_shift=0):
    """The plain gate post (countstep.get_bloom_gate_post) on a sorted
    batch: run-end dedup, one `bloom.bloom_insert` of the run ends.
    The probe hashes the raw key, so wide keys are decoded first.
    shard_shift: bf is a mesh shard's slice (bloom.bloom_insert).
    Returns (weights int32 [B], bf', undo) (bloom.bloom_insert)."""
    ends, mult = _runs(bkeys)
    h = decode_wide(bkeys) if wide else bkeys
    bf2, n_before, undo = bloom.bloom_insert(
        bf, h, ends, pre=pre, n_shift=bf_shift, n_hashes=bf_n_hash,
        shard_shift=shard_shift)
    return _gate_weights(ends, mult, n_before, bf_n_hash), bf2, undo


def bloom_gate_exact_post(bkeys, perm, bf, pre, bf_shift, bf_n_hash,
                          wide=False, shard_shift=0, rank=None,
                          rank_bound=None):
    """The serial-exact gate post (countstep._gate_batch(exact=True) with
    _serial_rank) on a batch sorted stably with its permutation `perm`:
    as bloom_gate_post, with each run's serial rank, the flat-batch lane
    of its first occurrence, which is perm at the run's first lane.  The
    flat batch is the fold's chunks in order, each chunk's windows in
    base order (the all-N pad chunks invalid), so the lane is the serial
    buffer position (htab.c:57-70).  A batch not in serial order (a mesh
    shard's routed batch) gives each lane's serial rank in `rank` (int
    [B], below rank_bound), read at that first lane; else rank_bound is
    B.  Returns (weights, bf', undo)."""
    ends, mult = _runs(bkeys)
    lane = torch.arange(bkeys.numel(), dtype=torch.int64,
                        device=bkeys.device)
    first = perm[lane - mult + 1]
    if rank is None:
        rank, rank_bound = first, bkeys.numel()
    else:
        rank = rank[first]
    h = decode_wide(bkeys) if wide else bkeys
    bf2, n_before, undo = bloom.bloom_insert(
        bf, h, ends, rank, pre=pre, n_shift=bf_shift, n_hashes=bf_n_hash,
        rank_bound=rank_bound, shard_shift=shard_shift)
    return _gate_weights(ends, mult, n_before, bf_n_hash), bf2, undo


SENT_PAD = (1 << 32) - 1   # a data key past every sentinel


def gate_sent_fits(bf_shift, shard_shift=0):
    """The sentinel post needs its (pos << 1 | 1) data keys below
    SENT_PAD and one sentinel per filter word (countstep.gate_sent_fits):
    decided on the filter's own bits, a mesh shard's slice having
    bf_shift - shard_shift."""
    return bf_shift - shard_shift <= 30


def bloom_gate_sentinel_post(bkeys, bf, pre, bf_shift, bf_n_hash,
                             wide=False, shard_shift=0):
    """The sentinel-merge gate post (countstep._gate_sent_a/_b): the
    probe as in bloom_gate_post, then the filter update without a
    searchsorted.  The run ends' probed positions enter one sort as data
    keys (pos << 1 | 1), with one sentinel key (w << 6) per filter word
    w in [0, nw]: sentinel w sorts after word w-1's data and before word
    w's.  The exclusive prefix sum of the unique positions' bit masks,
    read at the sentinels (pulled out in word order by the compaction
    kernel), gives each word's OR mask as the difference of adjacent
    sentinels (sums of unique bits, exact mod 2^32).  The filter comes
    back new; the undo record is the pre-fold filter itself.  On a mesh
    shard's slice (shard_shift) positions and words are the slice's
    own."""
    ends, mult = _runs(bkeys)
    h = decode_wide(bkeys) if wide else bkeys
    base, zs = bloom.probe_geom(h, pre=pre, n_shift=bf_shift,
                                n_hashes=bf_n_hash, shard_shift=shard_shift)
    n_before = bloom.probe_count(bf, base, zs, ends)
    nw = bf.shape[0]
    data = torch.stack([torch.where(ends, ((base + z) << 1) | 1, SENT_PAD)
                        for z in zs]).reshape(-1)
    sent = torch.arange(nw + 1, dtype=torch.int64, device=bf.device) << 6
    ks = torch.sort(torch.cat([data, sent])).values
    is_data = (ks & 1) == 1        # the pads too, after every sentinel
    uniq = is_data & (ks != torch.cat([ks[:1] ^ 1, ks[:-1]]))
    m = torch.where(uniq, torch.ones_like(ks) << ((ks >> 1) & 31), 0)
    cs = i32_bits(torch.cumsum(m, 0) - m)
    khi = torch.where(is_data, MARK_DROP, ks >> 6).to(torch.int32)
    _ohi, _olo, cvals, _n = compact.compact(khi, khi, cs)
    c = cvals[:nw + 1].to(torch.int64)
    return (_gate_weights(ends, mult, n_before, bf_n_hash),
            bf | i32_bits(c[1:] - c[:-1]), bf)


def run_bloom_gate_post(bkeys, bf, pre, bf_shift, bf_n_hash, wide=False,
                        shard_shift=0):
    """The gated fold's post (countstep.run_bloom_gate_post): the
    sentinel post where the filter (or a mesh shard's slice of it) fits
    (up to 2^30 bits) unless YAK_TPU_BLOOM_SENTINEL=0, else the plain
    post, whose sparse tail serves the large filters (-b37).  Returns
    (weights, bf', undo)."""
    post = (bloom_gate_sentinel_post
            if gate_sent_fits(bf_shift, shard_shift)
            and os.environ.get("YAK_TPU_BLOOM_SENTINEL", "1") != "0"
            else bloom_gate_post)
    with spans.span("gate.post"):
        return post(bkeys, bf, pre, bf_shift, bf_n_hash, wide, shard_shift)


# -- lookups ------------------------------------------------------------

QV_MAX_EK = 1 << 17          # -E marker budget per chunk
CHKERR_MAX_RUNS = 1 << 17    # chkerr marker budget per chunk


def lookup_chunk(carg, k, tkeys, tcnt, size, hook=None, psort=False):
    """Per-window table lookup of one chunk: extract, sort the queries
    with their lane index as payload (psort: through the sort kernel),
    merge-JOIN against the table.  k >= 32 queries are wide-encoded, as
    the table's keys are (0xFF..FF clamped to 0xFF..FE, so INT64_MAX
    stays the invalid lane; the JAX package looks these up outside its
    JOIN, by `get_*_step` with `lookup_impl(packable=False)`).  Returns
    (vals int32 [M], valid bool [M]) in lane order: the count of each
    valid window's k-mer, -1 where absent; invalid lanes -1.  `hook`,
    when given, is called with each phase's name as the phase is
    queued."""
    with spans.span("lookup.extract", hook):
        h, valid = extract(carg, k)
        h, valid = h.reshape(-1), valid.reshape(-1)
    vals = lookup_keys(h, valid, tkeys, tcnt, size, k > 31, psort, hook)
    return vals, valid


def lookup_keys(qkeys_raw, valid, tkeys, tcnt, size, wide, psort=False,
                mark=None):
    """The table count of each valid query, -1 where absent or invalid,
    in lane order (int32 [B]): the sort + JOIN tail of the lookups
    (countstep.lookup_pallas, KmerTable.lookup_hashes).  qkeys_raw int64
    [B] holds raw hashes (k >= 32: the u64 bit patterns, wide-encoded
    here as the table's keys are).  The queries are sorted with their
    lane as payload (psort: through the sort kernel, else torch.sort)
    and JOINed by the kernel, which stores each value at its lane; or,
    where `join_enabled` says no (YAK_TPU_JOIN=0, YAK_TPU_PALLAS=0),
    looked up by the sorted join (`sorttable.lookup`).  `mark`, when
    given, is called with "sort" and "join" as each phase is queued (the
    sorted join: "join" alone)."""
    keys = torch.where(valid, encode_wide(qkeys_raw) if wide else qkeys_raw,
                       INT64_MAX)
    if not join_enabled():
        with spans.span("lookup.join", mark):
            return st.lookup(tkeys, tcnt, size, keys)
    with spans.span("lookup.sort", mark):
        if psort:
            lane = torch.arange(keys.numel(), dtype=torch.int32,
                                device=keys.device)
            qkeys, order = sort.sort(keys, lane)
        else:
            qkeys, order = torch.sort(keys)
            order = order.to(torch.int32)
    with spans.span("lookup.join", mark):
        return merge.merge_join(tkeys, tcnt, size, qkeys, order)


def _cumsum0(mask):
    """[0, cumsum(mask)] as int32."""
    z = torch.zeros(1, dtype=torch.int32, device=mask.device)
    return torch.cat([z, torch.cumsum(mask, 0, dtype=torch.int32)])


def qv_chunk_stats(vals, has, meta, ns, M, min_frac, psort=False):
    """Per-segment sums and the three region histograms of one chunk
    (countstep._qv_chunk_stats; psort: get_qv_post_psort_mid and _fin,
    the region-key sort through the sort kernel).  meta i32 [2*ns+6]:
    bounds[ns+1], elig[ns], head_end, inc_start, j_inc, head_elig, cont.
    Returns (hg, hi_, hh int64 [1024], tot, non0 int32 [ns])."""
    dev = vals.device
    bounds = meta[:ns + 1]
    elig = meta[ns + 1:2 * ns + 1] != 0
    head_end = meta[2 * ns + 1]
    inc_start = meta[2 * ns + 2]
    ch = _cumsum0(has)
    cn = _cumsum0(has & (vals > 0))
    bc = torch.clamp(bounds, 0, M).to(torch.int64)
    tot = ch[bc[1:]] - ch[bc[:-1]]
    non0 = cn[bc[1:]] - cn[bc[:-1]]
    # the min_frac gate compares in float64, as qv.c:83 does
    gate = ((non0.to(torch.float64) >= tot.to(torch.float64) * min_frac)
            & elig)
    # expand the per-seg gate to lanes: its deltas added at the segment
    # starts, then a running sum
    gi = gate.to(torch.int32)
    gd = gi - torch.cat([gi.new_zeros(1), gi[:-1]])
    d = torch.zeros(M + 1, dtype=torch.int32, device=dev)
    d.index_add_(0, bc[:-1], gd)
    gl = torch.cumsum(d[:M], 0, dtype=torch.int32) > 0
    # region-coded histogram: [0,1024) gated complete lanes, [2048,3072)
    # the tail segment that continues into the next chunk, [3072,4096)
    # the head segment that continues the carried sequence, the rest
    # dead; one sort and one searchsorted (no host sync)
    t = torch.clamp(vals, 0, YAK_MAX_COUNT)
    lane = torch.arange(M, dtype=torch.int32, device=dev)
    key = torch.where(~has, 8000,
                      torch.where(lane < head_end, 3072 + t,
                                  torch.where(lane >= inc_start, 2048 + t,
                                              torch.where(gl, t, 1500))))
    sk = sort.sort(key)[0] if psort else torch.sort(key).values
    probes = torch.cat([torch.arange(1025, dtype=torch.int32, device=dev),
                        torch.arange(2048, 4097, dtype=torch.int32,
                                     device=dev)])
    edges = torch.searchsorted(sk, probes)
    hg = torch.diff(edges[:1025])
    hi_ = torch.diff(edges[1025:2050])
    hh = torch.diff(edges[2049:])
    return hg, hi_, hh, tot, non0


def qv_fold_step(state, meta, hg, hi_, hh, tot, non0, ns, min_frac):
    """One chunk's transition of the device-resident qv fold
    (countstep._qv_fold_step): settle the carried sequence against its
    completed totals, add the gated histogram, open the next carry from
    the tail region.  The middle piece is head_end == inc_start == 0
    with a live carry (c_tot >= 0; c_tot == -1 is "no carry")."""
    cnt, c_tot, c_non0, c_hist = state
    head_end = meta[2 * ns + 1]
    inc_start = meta[2 * ns + 2]
    # j_inc stays a 1-element index: indexing with a 0-d tensor reads
    # it back to the host, which would wait for the card every chunk
    j_inc = meta[2 * ns + 3:2 * ns + 4].to(torch.int64)
    tot_j = tot.index_select(0, j_inc)[0]
    non0_j = non0.index_select(0, j_inc)[0]
    head_elig = meta[2 * ns + 4] != 0
    cont = meta[2 * ns + 5] != 0
    mid = (head_end == 0) & (inc_start == 0) & (c_tot >= 0)
    settle = ~mid & (c_tot >= 0)
    tot_c = c_tot + torch.where(mid, tot_j, tot[0])
    non0_c = c_non0 + torch.where(mid, non0_j, non0[0])
    g_c = ~(non0_c.to(torch.float64)
            < tot_c.to(torch.float64) * min_frac) & head_elig
    cnt = cnt + hg + torch.where(settle & g_c, c_hist + hh, 0)
    # the host's cont flag, not inc_start < M: a record header in the
    # chunk's last k-1 cells gives a zero-window tail piece whose carry
    # must still open
    new_active = cont | mid
    n_tot = torch.where(mid, tot_c, tot_j)
    n_non0 = torch.where(mid, non0_c, non0_j)
    n_hist = torch.where(mid, c_hist + hi_, hi_)
    return (cnt, torch.where(new_active, n_tot, -1),
            torch.where(new_active, n_non0, 0),
            torch.where(new_active, n_hist, 0))


def qv_ek_markers(vals, has, M):
    """-E markers (countstep._qv_ek_markers): the ascending lanes of the
    windows that are extracted with count 0 or absent, cut to
    QV_MAX_EK, and their true number."""
    em = has & (vals <= 0)
    lane = torch.arange(M, dtype=torch.int32, device=vals.device)
    key = torch.sort(torch.where(em, lane, (1 << 31) - 1)).values
    return key[:QV_MAX_EK], em.sum(dtype=torch.int32)


def qv_join_post(vals, valid, meta, state, ns, M, min_frac, emit_ek,
                 psort=False):
    """The qv post of one chunk (countstep.get_qv_join_post without its
    order restore; psort: run_qv_join_post_psort, which the JAX package
    takes only without -E): the reduction and the fold.  Returns (cnt,
    c_tot, c_non0, c_hist, tot, non0) and, with emit_ek, (markers, n)
    after."""
    hg, hi_, hh, tot, non0 = qv_chunk_stats(vals, valid, meta, ns, M,
                                            min_frac, psort)
    r = qv_fold_step(state, meta, hg, hi_, hh, tot, non0, ns,
                     min_frac) + (tot, non0)
    if emit_ek:
        r = r + qv_ek_markers(vals, valid, M)
    return r


# payload of an invalid query lane in the seg-payload join: its post key
# sorts above every real seg << 11 | v (seg ids stay below 2^21 - 1; ns
# never exceeds 2^20)
SEG_INVALID = (1 << 21) - 1


def seg_of_lane(bounds, ns, M):
    """Each lane's segment id from the qv meta row's bounds (the first
    window lane of each segment, clipped to M) (_seg_of_lane): ones
    added at the interior bounds, then a running sum."""
    bc = torch.clamp(bounds[1:ns + 1], 0, M).to(torch.int64)
    d = torch.zeros(M + 1, dtype=torch.int32, device=bounds.device)
    d.index_add_(0, bc, torch.ones_like(bc, dtype=torch.int32))
    return torch.cumsum(d[:M], 0, dtype=torch.int32)


def qv_lookup_seg(carg, k, tkeys, tcnt, size, meta, ns, hook=None):
    """The seg-payload JOIN of one qv chunk (get_qv_join_pre_seg and its
    kernel call, YAK_TPU_QV_SEG=1, k <= 31): extract, the queries sorted
    by torch.sort with each one's segment id (SEG_INVALID for invalid
    lanes) riding along, and the JOIN kernel with the identity as its
    store lanes, so the values stay in ascending key order beside their
    segments.  Returns (vals int32 [M], seg int32 [M]) in that order,
    for `qv_join_post_seg`.  `hook` marks "extract", "sort", "join"."""
    with spans.span("lookup.extract", hook):
        h, valid = extract(carg, k)
        h, valid = h.reshape(-1), valid.reshape(-1)
    M = h.numel()
    with spans.span("lookup.sort", hook):
        seg = torch.where(valid, seg_of_lane(meta, ns, M), SEG_INVALID)
        qkeys, order = torch.sort(torch.where(valid, h, INT64_MAX))
    with spans.span("lookup.join", hook):
        lane = torch.arange(M, dtype=torch.int32, device=h.device)
        vals = merge.merge_join(tkeys, tcnt, size, qkeys, lane)
    return vals, seg[order]


def _seg_hist(k2, ej, j):
    """One segment's occurrence histogram from the sorted seg << 11 | v
    key (_seg_hist): bin 0 counts v in {0, 1} (absent and count 0), bin
    t counts v == t + 1.  j int64 [1], so no value is read back to the
    host."""
    probes = (j << 11) + torch.arange(2, 1026, dtype=torch.int64,
                                      device=k2.device)
    edges = torch.searchsorted(k2, probes)
    return torch.diff(torch.cat([ej.index_select(0, j), edges]))


def qv_join_post_seg(vals, seg, meta, state, ns, M, min_frac):
    """The qv post of one chunk from the seg-payload JOIN
    (get_qv_join_post_seg with _seg_sorted_vals and _seg_edges,
    yak_tpu/ops/countstep.py:1529-1656): one sort of seg << 11 | v + 1
    restores the grouping, each segment's total and nonzero count and
    the head and tail histograms are searchsorted edges, and the gated
    histogram one narrow sort of the gated lanes' values.  Returns (cnt,
    c_tot, c_non0, c_hist, tot, non0), as qv_join_post without -E."""
    dev = vals.device
    k2 = torch.sort((seg.to(torch.int64) << 11)
                    | (vals + 1).to(torch.int64)).values
    sj = torch.arange(ns + 1, dtype=torch.int64, device=dev) << 11
    ej = torch.searchsorted(k2, sj)
    e2 = torch.searchsorted(k2, sj[:-1] | 2)
    tot = (ej[1:] - ej[:-1]).to(torch.int32)
    non0 = (ej[1:] - e2).to(torch.int32)
    elig = meta[ns + 1:2 * ns + 1] != 0
    head_end = meta[2 * ns + 1]
    inc_start = meta[2 * ns + 2]
    j_inc = meta[2 * ns + 3:2 * ns + 4].to(torch.int64)
    gate = (non0.to(torch.float64) >= tot.to(torch.float64) * min_frac) \
        & elig
    # the head region [0, head_end) is exactly seg 0, the tail region
    # [inc_start, M) exactly seg j_inc
    has_head = head_end > 0
    has_inc = inc_start < M
    hh = torch.where(has_head, _seg_hist(k2, ej, j_inc.new_zeros(1)), 0)
    hi_ = torch.where(has_inc, _seg_hist(k2, ej, j_inc), 0)
    ji = torch.arange(ns, dtype=torch.int64, device=dev)
    g_hg = gate & ~(has_head & (ji == 0)) & ~(has_inc & (ji == j_inc))
    # the gate expanded to the sorted stream's lanes: deltas at the seg
    # starts (the last closes the invalid tail), a running sum
    gi = torch.cat([g_hg.to(torch.int32),
                    torch.zeros(1, dtype=torch.int32, device=dev)])
    gd = gi - torch.cat([gi.new_zeros(1), gi[:-1]])
    d = torch.zeros(M + 1, dtype=torch.int32, device=dev)
    d.index_add_(0, ej, gd)
    glx = torch.cumsum(d[:M], 0, dtype=torch.int32) > 0
    k3 = torch.sort(torch.where(glx, k2 & 0x7FF, 2048)).values
    hedges = torch.searchsorted(k3, torch.arange(2, 1026, dtype=torch.int64,
                                                 device=dev))
    hg = torch.diff(torch.cat([hedges.new_zeros(1), hedges]))
    return qv_fold_step(state, meta, hg, hi_, hh, tot, non0, ns,
                        min_frac) + (tot, non0)


def chkerr_mark_mid(vals, valid, min_cnt, M):
    """chkerr's run markers as planes for the compaction
    (countstep.get_chkerr_mark_mid): a lane is low when its window is
    valid and its count is below min_cnt (absent counts as low); each
    low run's last lane keeps its lane number in khi and the run length
    in the payload, every other lane is MARK_DROP.  Returns (khi int32
    [M], runlen int32 [M], n int32 [])."""
    low = valid & (vals < min_cnt)
    lane = torch.arange(M, dtype=torch.int32, device=vals.device)
    last_high = torch.cummax(torch.where(low, -1, lane), 0).values
    runlen = lane - last_high
    is_end = low & ~torch.cat([low[1:], low.new_zeros(1)])
    khi = torch.where(is_end, lane, MARK_DROP)
    return khi, runlen, is_end.sum(dtype=torch.int32)


def run_mark_compact(khi, pay):
    """Marker compaction (countstep.run_mark_compact with
    get_mark_slice_post): (khi lane-or-MARK_DROP, payload) -> (lanes,
    payloads) int32 [M], the kept lanes first in lane order.  The JAX
    version cuts the planes to the marker budget; here the caller cuts
    its copy to the host, so a chunk with more markers than the budget
    still finds all of them on the device.  khi also fills the
    compaction's middle plane, which nothing reads."""
    ohi, _olo, opay, _n = compact.compact(khi, khi, pay)
    return ohi, opay


def run_marker_sort(khi, pay, kernel=True):
    """The psort engine's marker step (countstep.get_chkerr_psort_mid's
    planes through run_marker_psort), in place of run_mark_compact: key =
    the run-end lane where khi keeps one, else INT32_MAX, payload = the
    run length, one sort through the kernel; without `kernel`, one
    torch.sort (the full-lane marker sort of the JAX package's non-JOIN
    and MARK_COMPACT=0 steps, get_chkerr_step, get_trioeval_join_post).
    Returns (lanes, payloads) int32 [M], the markers first in lane
    order, as run_mark_compact."""
    key = torch.where(khi >= 0, khi, INT32_MAX)
    if kernel:
        return sort.sort(key, pay)
    lanes, order = torch.sort(key)
    return lanes, pay[order]


def marker_step(psort, diff=False):
    """The marker step of chkerr and trioeval (run markers) or triobin -p
    (`diff`) for a run: through the sort kernel under psort, else by the
    compaction kernel where `mark_compact_enabled`, else by one
    torch.sort."""
    if psort:
        return run_diff_sort if diff else run_marker_sort
    if mark_compact_enabled():
        return run_mark_compact
    return (lambda khi, pay: (run_diff_sort if diff else run_marker_sort)(
        khi, pay, kernel=False))


# -- trio binning and evaluation -------------------------------------------

TRIOBIN_MAX_DIFF = 1 << 18   # triobin -p marker budget per chunk
TRIOEVAL_MAX_RUNS = 1 << 17  # trioeval run-marker budget per chunk


def trio_types(vals, valid):
    """The hap-mer typing of a lookup's value stream (countstep._te_emit,
    _triobin_reduce): flag = the table value where the window is valid
    (absent counts 0); c1 = flag & 3 is the pat class, c2 = flag >> 2 & 3
    the mat class; type 1 (pat-strong) where c1 == 2 and c2 == 0, type 2
    (mat-strong) where c2 == 2 and c1 == 0, else 0.  Returns (flag, typ)
    int32 [M]."""
    flag = torch.where(valid, vals.clamp(min=0), 0).to(torch.int32)
    c1, c2 = flag & 3, (flag >> 2) & 3
    typ = torch.where(valid & (c1 == 2) & (c2 == 0), 1,
                      torch.where(valid & (c2 == 2) & (c1 == 0), 2, 0))
    return flag, typ.to(torch.int32)


def _type_runs(typ):
    """Runs of equal type: (lane, run_start, runlen, is_end) int32/bool
    [M], run_start the last run head at or before each lane."""
    lane = torch.arange(typ.numel(), dtype=torch.int32, device=typ.device)
    fill = typ.new_full((1,), -1)
    run_start = last_set_lane(typ != torch.cat([fill, typ[:-1]]))
    is_end = typ != torch.cat([typ[1:], fill])
    return lane, run_start, lane - run_start + 1, is_end


def triobin_reduce(flag, typ, valid, meta, k, M):
    """tb_worker's per-contig reductions of one chunk
    (countstep._triobin_reduce, triobin.c:41-101).  meta int32 [ns+2]:
    the segment bounds [ns+1] (record starts clipped to M, then M), then
    `we`, the last window of the final piece.

    Eight segment sums by int32 cumsum differences over the bounds
    clipped to [0, M]: #k-mers, the flag counts c[0], c[1], c[2], c[4],
    c[8], and the summed lengths of the type-1 and type-2 streaks of at
    least k-4 windows that touch neither lane 0 nor `we`.  Those two
    boundary runs come back as scalars [typ[0], head_len, tail_typ,
    tail_len] for the host to merge across chunk-spanning pieces.
    Returns int32 [8*ns + 4]: the sums row-major [8, ns], then the four
    scalars, one tensor for one copy to the host.

    The eight planes take one cumsum over their concatenation, a 1-D
    scan (torch.cumsum along dim 1 of [8, M] runs a row in one block);
    each plane's total is at most M, so the whole stays below 2^31, and
    a sum is a difference within one plane."""
    bounds, we = meta[:-1], meta[-1]
    lane, run_start, runlen, is_end = _type_runs(typ)
    strk = (is_end & (typ > 0) & (runlen >= k - 4) & (run_start > 0)
            & (lane < we))
    x = torch.stack([valid] + [valid & (flag == v) for v in (0, 1, 2, 4, 8)]
                    + [torch.where(strk & (typ == t), runlen, 0)
                       for t in (1, 2)]).to(torch.int32)
    cs = _cumsum0(x.reshape(-1))
    bc = torch.clamp(bounds, 0, M).to(torch.int64)
    at = (torch.arange(8, dtype=torch.int64, device=bc.device)[:, None] * M
          + bc[None, :])
    sums = cs[at[:, 1:]] - cs[at[:, :-1]]
    at_we = lane == we
    scalars = torch.stack([typ[0], (run_start == 0).sum(dtype=torch.int32),
                           torch.where(at_we, typ, 0).sum(dtype=torch.int32),
                           torch.where(at_we, runlen, 0)
                           .sum(dtype=torch.int32)])
    return torch.cat([sums.reshape(-1), scalars])


def triobin_diff_mid(flag, valid, M):
    """triobin -p's markers as planes for the compaction
    (countstep._triobin_reduce with emit_diff, triobin.c:89-92): each
    valid window whose pat and mat classes differ keeps its lane in khi
    and `flag & 15` in the payload (a non-trio table's larger values
    must not reach the row); every other lane is MARK_DROP.  Returns
    (khi, payload int32 [M], n int32 [])."""
    dm = valid & ((flag & 3) != ((flag >> 2) & 3))
    lane = torch.arange(M, dtype=torch.int32, device=flag.device)
    return (torch.where(dm, lane, MARK_DROP), flag & 15,
            dm.sum(dtype=torch.int32))


def run_diff_sort(khi, pay, kernel=True):
    """The psort engine's -p marker step (get_triobin_psort_mid's plane
    through run_marker_psort1), in place of run_mark_compact: one sort of
    `lane << 4 | flag` keys, INT32_MAX where khi drops the lane, through
    the kernel, or without `kernel` one torch.sort (the JAX package's
    triobin steps sort these keys in XLA).  Returns (lanes, flags) int32
    [M], the markers first in lane order, as run_mark_compact."""
    key = torch.where(khi >= 0, (khi << 4) | pay, INT32_MAX)
    keys = sort.sort(key)[0] if kernel else torch.sort(key).values
    return keys >> 4, keys & 15


def trioeval_mark_mid(typ, we, min_n, M):
    """trioeval's run markers as planes for the compaction
    (countstep._te_emit with get_trioeval_mark_mid): the last lane of
    each run of type > 0 that is long enough (>= min_n) or touches lane 0
    or `we` keeps its lane in khi and `runlen << 2 | typ` in the
    payload; every other lane is MARK_DROP.  Returns (khi, payload int32
    [M], n int32 [])."""
    lane, run_start, runlen, is_end = _type_runs(typ)
    emit = is_end & (typ > 0) & ((runlen >= min_n) | (run_start == 0)
                                 | (lane == we))
    return (torch.where(emit, lane, MARK_DROP), (runlen << 2) | typ,
            emit.sum(dtype=torch.int32))


# -- sexchr ---------------------------------------------------------------

def sexchr_reduce(vals, valid, bounds, M):
    """sc_worker's per-segment sums of one chunk (countstep._sexchr_reduce,
    get_sexchr_join_post, sexchr.c:61-71): with flag = the table value
    where the window is valid (absent counts 0), the number of valid
    windows, of flag > 0, of flag == 1 and of flag == 2 in each segment
    [bounds[j], bounds[j+1]), the bounds clipped to [0, M].  Returns
    int32 [4 * ns], the sums row-major [4, ns], one tensor for one copy
    to the host.  The four planes take one cumsum over their
    concatenation, as in triobin_reduce (a row-wise cumsum would scan
    each row in one block); each plane's total is at most M."""
    flag = torch.where(valid, vals.clamp(min=0), 0)
    x = torch.stack([valid, flag > 0, flag == 1, flag == 2]).to(torch.int32)
    cs = _cumsum0(x.reshape(-1))
    bc = torch.clamp(bounds, 0, M).to(torch.int64)
    at = (torch.arange(4, dtype=torch.int64, device=bc.device)[:, None] * M
          + bc[None, :])
    return (cs[at[:, 1:]] - cs[at[:, :-1]]).reshape(-1)
