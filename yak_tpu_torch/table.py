"""KmerTable: the counting table of the count path.

Port of `yak_tpu/table.py` for `count` on one device, k in [1, 63], with
the Bloom prefilter of `-b`: the sorted (hash, count) table lives on its
device between folds; host code chunks are grouped and folded in one
step each (extract + sort [+ Bloom gate] + merge-reduce,
`ops/countstep.py`); the overflow flag of a fold is read one fold late,
and an overflowed fold is replayed against the preserved pre-fold table
after doubling its capacity.  Reads (items, hist, shrink, dump) flush
first.

k >= 32 keys are held wide-encoded (`ops/keys.encode_wide`) so that the
table's int64 order is their unsigned order; items, to_arrays,
from_arrays, dump and restore speak raw u64 hashes.

The Bloom filter (`bf_shift`, `bf_n_hash`) exists when the reference
would make one (bf_shift > pre and 9 <= bf_shift - pre <= 55,
bbf.c:9, htab.c:23-27) and gates the folds that create keys.  A gated
fold changes the filter, so the one-fold-late replay first takes the
filter back to its pre-fold state with the fold's undo record
(`ops/bloom.rollback`): the pre-fold filter kept by reference where
the update built a new one (up to -b30), or the old values of the words
an in-place update touched (larger filters: a copy of a -b37 filter
would take 16 GiB).

Each fold takes the engine `ops/countstep.fold_engine` names, read at
each fold as yak_tpu's `_pallas_mode` reads it: the default (pmerge,
`torch.sort` batch sort and the merge-reduce kernel), psort (the batch
sort through the sort kernel), compact (the sort-merge's merged stream
closed up by the compaction kernel) or xla (the sort-merge in plain
torch); the one-fold-late replay re-runs a fold on the engine it took.

The lookup workloads (qv, chkerr, triobin, trioeval) read `keys`, `cnt`
and `size` after `flush` and JOIN their queries against them
(`ops/countstep.lookup_chunk`).  `restore(into=)` ORs a second `.yak`
file's flags into a table (`load_trio_tables`), through the plain
sort-merge's OR mode, as the JAX package does in XLA.

The table algebra (`merge`, `subtract`, `isec`, `getseq`, yak_ch_*,
htab.c:241-367) runs through the same kernels: `merge`, cntasm's
presence vote, folds `other`'s selected keys into the table by the
merge-reduce in count mode; `subtract` and `isec` JOIN the table's own
keys, already ascending, against `other` and compact the survivors.

With `bf_exact` (-X), the gated folds and raw hash batches take the
serial-exact gate (`countstep.bloom_gate_exact_post` on the default
engine, `countstep.gate_batch` on the sort-merge engines and for raw
hash batches), whose pass-1 key
set is the reference's bit for bit even when pass 2 reads another file;
a fold whose packed rank key would not fit refuses before it runs
(`_warn_exact_gate`), as does the psort engine, which has no such gate.

A shard of a `parallel.mesh.MeshTable` of 2^shard_shift shards holds
its slice of the filter (2^(bf_shift - shard_shift) bits,
`ops/bloom.bloom_insert`) and folds its routed batches through
`fold_hashes`, gated in pass 1 like a fold of code chunks.
The TPU package's transient-fault retry (`yak_tpu/table.py:493-502`) is
deliberately absent: on the card it would hide a fault.
"""

import sys

import numpy as np
import torch

from yak_tpu_torch import YAK_LOAD_ALL, YAK_MAX_COUNT, spans
from yak_tpu_torch.io import yakfmt
from yak_tpu_torch.io.pack import detect_periodic, pack_planes, pack_planes2
from yak_tpu_torch.ops import bloom, countstep, merge
from yak_tpu_torch.ops import sorttable as st
from yak_tpu_torch.ops.hash import hash64_inv
from yak_tpu_torch.ops.keys import (INT64_MAX, decode_wide, encode_wide,
                                    torch_to_u64, u32_to_torch,
                                    u64_to_torch)
from yak_tpu_torch.ops.kmers import MAX_K


def _log(msg):
    print(f"[M::yak_tpu_torch] {msg}", file=sys.stderr)


def makes_filter(bf_shift, pre):
    """Whether -b bf_shift makes a Bloom filter: a per-shard filter of at
    least one 512-bit block and at most 2^64 bits, else yak_bf_init
    returns NULL and counting runs ungated (bbf.c:9, htab.c:23-27)."""
    return 9 <= bf_shift - pre <= 64 - 9


def check_exact_gate(bf_shift, bf_n_hash, lanes, rank_bound=None,
                     shard_shift=0):
    """Refuse a gated fold of `lanes` lanes that the serial-exact gate
    (-X) could not serve (its packed sort key would not fit 64 bits),
    before it runs, as yak_tpu/table.py:269-285 does: the exact-dump
    cross-check would only find it after a full count.  The rank bound
    is the fold's own where it carries ranks (a mesh's: a group's lanes,
    `parallel.mesh.count_file_mesh`, its filter slices shard_shift bits
    narrower), else 2 * lanes + 4096, yak_tpu's, so the same -b/-H/-K
    refuse."""
    if not bloom.exact_gate_fits(bf_shift, bf_n_hash,
                                 rank_bound or 2 * lanes + 4096,
                                 shard_shift):
        raise ValueError(
            f"-X (byte-exact dump) cannot engage the serial-exact "
            f"Bloom gate for -b{bf_shift} -H{bf_n_hash} "
            f"with {lanes} lanes/fold: the packed (position, rank) "
            f"sort key exceeds 64 bits.  Use a smaller -b/-K or "
            f"drop -X (the default dump has identical content).")


class KmerTable:
    """Deferred-merge note: code chunks accumulate on the host and fold
    into the sorted table in groups, so duplicates across a whole group
    coalesce in one merge; saturating counts are unaffected because
    min(c + m1 + m2, 1023) == min(min(c + m1, 1023) + m2, 1023).

    `device` is required: the table and every fold live there.  A CUDA
    device runs the hand-written kernels, the CPU their plain torch
    versions.  `phase_hook`, when set, is called with the name of each
    fold phase as it is queued ("start", "h2d", "extract", "sort",
    "gate" on a gated fold, "merge", "finalize"), for per-phase
    timing; the phases are the spans `table.stage` and `fold.*`
    (spans.py).  `bf_exact`: gate through the serial-exact gate (-X).
    `shard_shift`: the table is a shard of a mesh of 2^shard_shift
    shards, and its filter that shard's slice."""

    def __init__(self, k, pre=10, cap_log2=16, flush_lanes=None,
                 cap_hinted=None, *, device, bf_shift=0, bf_n_hash=4,
                 bf_exact=False, shard_shift=0):
        if pre < 10:
            raise ValueError("pre must be at least YAK_COUNTER_BITS (10)")
        if not 1 <= k <= MAX_K:
            raise ValueError(f"k={k}: k must be in [1, {MAX_K}]")
        self.k = k
        self.pre = pre
        self.wide = k > 31
        self.device = torch.device(device)
        self.flush_lanes = flush_lanes  # None = max(2^23, cap)
        # explicit capacity hint (-K): skip the group-size growth prior
        self._cap_hinted = cap_log2 > 16 if cap_hinted is None \
            else cap_hinted
        self.keys, self.cnt, self.size = st.make_table(1 << cap_log2,
                                                       self.device)
        self._tot = 0          # host mirror of size (settled folds)
        self._pend = []        # deferred (h, add, valid) hash batches
        self._pend_lanes = 0
        self._pend_codes = []  # deferred host code chunks (count path)
        self._pend_create = True
        # one-step-late overflow bookkeeping: (pre-fold state, fold
        # input, device overflow flag, the filter's undo record or None,
        # the fold's engine)
        self._last_step = None
        self._group_g = None   # fixed chunks-per-group
        self.phase_hook = None
        self.bf = None
        self.bf_shift = bf_shift
        self.bf_n_hash = bf_n_hash
        self.bf_exact = bf_exact
        self.shard_shift = shard_shift
        if makes_filter(bf_shift, pre):     # a mesh shard holds its slice
            self.bf = bloom.make_bloom(bf_shift - shard_shift, self.device)

    @property
    def cap(self):
        return self.keys.shape[0]

    @property
    def tot(self):
        self.flush()
        self._tot = int(self.size)
        return self._tot

    def _ensure_capacity(self, need):
        if need <= self.cap:
            return
        new_cap = self.cap
        while new_cap < need:
            new_cap *= 2
        self.keys, self.cnt, self.size = st.grow(self.keys, self.cnt,
                                                 self.size, new_cap)

    # -- hot path -------------------------------------------------------

    def insert_codes(self, codes, create_new=True, planes=None,
                     periodic=None):
        """Queue one fixed-size flat base-code chunk (uint8, 4 = N/pad).

        Chunks accumulate on the host, bit-plane packed here (2 bits a
        base for the periodic fixed-length-read layout, 3 otherwise),
        and fold into the table in groups.  All chunks of a table share
        a length.  `planes` (the native reader's pre-packed (plo, phi,
        pnn)) skips the packing; `periodic` skips the layout scan: a
        (R, w) tuple, or False for known-general.
        """
        if self._pend_create != create_new:
            self.flush()
            self._pend_create = create_new
        per = detect_periodic(codes) if periodic is None \
            else (periodic or None)
        if per is not None:
            plo, phi = planes[:2] if planes is not None \
                else pack_planes2(codes)
            self._pend_codes.append((codes, plo, phi, None, per))
        else:
            plo, phi, pnn = planes if planes is not None \
                else pack_planes(codes)
            self._pend_codes.append((codes, plo, phi, pnn, None))
        if self._group_g is None:
            lanes = max(codes.shape[0] - self.k + 1, 1)
            target = self.flush_lanes or max(1 << 23, self.cap)
            self._group_g = max(1, -(-target // lanes))
        if len(self._pend_codes) >= self._group_g:
            self._fold_codes()

    def _fold_codes(self):
        """Fold pending code chunks, padded to the next power of two of
        chunks (at most the full group size) with all-N chunks, so a
        run sees at most log2(G) fold shapes."""
        if not self._pend_codes:
            return
        group = self._pend_codes
        self._pend_codes = []
        g_full = self._group_g or len(group)
        g = min(g_full, 1 << max(len(group) - 1, 0).bit_length())
        L = group[0][0].shape[0]
        with spans.span("table.stage", self.phase_hook, opens="start",
                        mark="h2d"):
            carg = self._stage(group, g, L)
        self._queue_fold(carg, g * max(L - self.k + 1, 1),
                         self.bf is not None and self._pend_create)

    def _stage(self, group, g, L):
        """The group's planes joined on the host, padded to g chunks, and
        uploaded (the span `table.upload`: pageable copies, each of which
        waits for the work queued before it, and the 3-plane path's
        joins between them): `countstep.extract`'s argument."""
        n_pad = g - len(group)
        pw = [e[4] for e in group]
        periodic = (all(p is not None for p in pw)
                    and len({p[0] for p in pw}) == 1)
        dev = self.device
        if periodic:
            R = pw[0][0]
            # all-pad fill chunks are trivially periodic with w=0
            wvec = np.array([p[1] for p in pw] + [0] * n_pad, np.int32)
            zw = np.zeros((n_pad, group[0][1].shape[1]), np.uint32)
            plo = np.concatenate([e[1] for e in group] + [zw])
            phi = np.concatenate([e[2] for e in group] + [zw])
            with spans.span("table.upload"):
                return ("periodic", (u32_to_torch(plo, dev),
                                     u32_to_torch(phi, dev),
                                     torch.from_numpy(wvec).to(dev)), L, R)
        pl3s = [pack_planes(e[0]) if e[3] is None
                else (e[1], e[2], e[3]) for e in group]
        W = pl3s[0][0].shape[1]
        padw = np.zeros((n_pad, W), np.uint32)
        padn = np.full((n_pad, W), 0xFFFFFFFF, np.uint32)
        with spans.span("table.upload"):
            return ("planes", tuple(
                u32_to_torch(np.concatenate(
                    [p[j] for p in pl3s] + [padn if j == 2 else padw]), dev)
                for j in range(3)), L)

    def fold_hashes(self, h, valid, create_new=True, rank=None,
                    rank_bound=None):
        """Fold one batch of raw hashes (int64 [B] on the table's device;
        k >= 32 the u64 bit patterns) with its validity (bool [B]), as a
        fold of code chunks goes: the previous fold settled one fold
        late, the capacity prior, the engine that `countstep.fold_engine`
        names, the batch kept for an overflow replay.  create_new=False
        increments existing keys only (htab.c:71-75).  This is how a shard of a `parallel.mesh.MeshTable`
        folds the hashes routed to it (the per-chip sort, Bloom gate and
        merge-reduce of yak_tpu's mesh count step,
        yak_tpu/parallel/mesh.py:338-426).

        Through a live filter a creating fold is gated, the batch as one
        gating batch (the cheap gate sees the filter as it was before
        it).  With bf_exact, `rank` (int [B], below rank_bound) gives
        each lane's serial position, as the serial-exact gate needs when
        the batch is not in serial order; without it the lane is the
        rank."""
        if self._pend_codes or self._pend or self._pend_create != create_new:
            self.flush()
            self._pend_create = create_new
        with spans.span("table.stage", self.phase_hook, opens="start",
                        mark=None):
            carg = ("hashes", (h, valid))
            if rank is not None:
                carg += ((rank, rank_bound),)
        self._queue_fold(carg, h.numel(),
                         self.bf is not None and create_new)

    def _queue_fold(self, carg, lanes, gated):
        """Queue one fold of `carg` (`countstep.extract`'s argument) over
        `lanes` lanes after settling the previous one, and keep what an
        overflow replay needs."""
        self._check_last_step()  # one step late: previous fold settled
        exact = gated and self.bf_exact
        if exact:
            self._warn_exact_gate(lanes, carg[2][1] if len(carg) == 3
                                  and carg[0] == "hashes" else None,
                                  self.shard_shift)
        # the engine is read at each fold (table._pallas_mode); -X on the
        # psort engine raises here
        engine = countstep.fold_engine(self.k, gated, exact)
        # capacity prior (only without an explicit cap hint): a fold of
        # L lanes creates at most L keys and typically ~L/2 distinct
        if not self._cap_hinted and self.cap * 2 < lanes:
            need = 1 << max((lanes // 2 - 1).bit_length(), 14)
            self.keys, self.cnt, self.size = st.grow(
                self.keys, self.cnt, self.size, need)
        prev = (self.keys, self.cnt, self.size)
        ovf, undo = self._run_step(carg, prev, gated, engine)
        self._last_step = (prev, carg, ovf, undo, engine)

    def _run_step(self, carg, state, gated, engine):
        """Queue one fold against `state` (keys, cnt, size), through the
        Bloom gate when `gated`, on `engine` (`countstep.fold_engine`);
        leaves the result in self.* (and the filter in self.bf); returns
        the device overflow flag and the filter's undo record (None when
        ungated)."""
        keys, cnt, size = state
        gate = ((self.bf, self.pre, self.bf_shift, self.bf_n_hash,
                 self.bf_exact, self.shard_shift) if gated else None)
        (self.keys, self.cnt, self.size, _n_new, ovf, bf,
         undo) = countstep.count_step(carg, self.k, keys, cnt, size,
                                      self._pend_create, gate=gate,
                                      hook=self.phase_hook, engine=engine)
        if gated:
            self.bf = bf
        return ovf, undo

    def _warn_exact_gate(self, lanes, rank_bound=None, shard_shift=0):
        """check_exact_gate for this table's -b and -H."""
        check_exact_gate(self.bf_shift, self.bf_n_hash, lanes, rank_bound,
                         shard_shift)

    def _check_last_step(self):
        """Settle the previous fold: on overflow, double the preserved
        pre-fold table, take the filter back to its pre-fold state, and
        replay the fold on its own engine (the step never writes into
        its table inputs, so that state is intact)."""
        if self._last_step is None:
            return
        prev, carg, ovf, undo, engine = self._last_step
        self._last_step = None
        with spans.span("table.settle"):
            while bool(ovf):
                spans.count("table.replays")
                keys, cnt, size = prev
                prev = st.grow(keys, cnt, size, 2 * keys.shape[0])
                # self.cap must reflect the grown table before the replay
                self.keys, self.cnt, self.size = prev
                gated = undo is not None
                if gated:
                    self.bf = bloom.rollback(self.bf, undo)
                ovf, undo = self._run_step(carg, prev, gated, engine)

    def insert_hashes(self, h, valid, create_new=True):
        """Count a raw (duplicate-bearing) int64 hash batch into the table
        (deferred; folded in at the next flush by the plain sort-merge,
        as the JAX package folds it by its XLA merge_batch).  k >= 32
        hashes are the raw u64 bit patterns.  create_new=False
        increments existing keys only (htab.c:71-75).

        Through a live filter, a creating batch is gated at once, as
        yak_ch_insert_list gates it (htab.c:51-78; yak_tpu/table.py:
        545-581), by `countstep.gate_batch`: each key run's weight is
        its length, less one where its probed bits were not all set;
        with bf_exact the gate is serial-exact, a key's rank the batch
        lane of its first occurrence (the caller's order is the serial
        order)."""
        h, valid = h.to(self.device), valid.to(self.device)
        if self.bf is not None and create_new:
            keys = torch.where(valid, encode_wide(h) if self.wide else h,
                               INT64_MAX)
            h, starts, add, self.bf, _undo = countstep.gate_batch(
                keys, self.bf, self.pre, self.bf_shift, self.bf_n_hash,
                self.bf_exact, wide=self.wide, shard_shift=self.shard_shift)
            valid = starts & (add > 0)
        else:
            h = encode_wide(h) if self.wide else h
            add = torch.ones(h.shape, dtype=torch.int32, device=self.device)
        if create_new != self._pend_create:
            self.flush()
            self._pend_create = create_new
        self._pend.append((h, add, valid))
        self._pend_lanes += h.shape[0]
        if self._pend_lanes >= (self.flush_lanes or max(1 << 23, self.cap)):
            self.flush()

    def flush(self):
        """Fold all pending inserts into the table and settle overflow."""
        self._fold_codes()
        self._check_last_step()
        if not self._pend:
            return
        h, add, valid = (torch.cat([p[j] for p in self._pend])
                         for j in range(3))
        self._pend, self._pend_lanes = [], 0
        if self._pend_create:
            # the live size, not the host mirror: code folds since the
            # last read leave _tot stale, and a short table would truncate
            self._ensure_capacity(int(self.size) + h.shape[0])
        self.keys, self.cnt, self.size, _, _ = st.merge_batch(
            self.keys, self.cnt, self.size, h, add, valid,
            create=self._pend_create)
        self._tot = int(self.size)

    def lookup_hashes(self, h, valid):
        """int32 counts per lane of raw hashes `h` (int64; k >= 32 the u64
        bit patterns), -1 where absent or not `valid` (yak_ch_get):
        sorted and JOINed by `countstep.lookup_keys`, on the psort
        engine under YAK_TPU_PSORT=1 (by the sorted join where the JOIN
        is off)."""
        self.flush()
        return countstep.lookup_keys(h.to(self.device),
                                     valid.to(self.device), self.keys,
                                     self.cnt, self.size, self.wide,
                                     countstep.psort_enabled())

    # -- cold-path table ops --------------------------------------------

    def _raw(self, keys):
        """Table keys -> raw hashes (k >= 32 keys are wide-encoded)."""
        return decode_wide(keys) if self.wide else keys

    def items(self):
        """Host (hash u64[N], count i32[N]) of live entries (sorted)."""
        n = self.tot
        return (torch_to_u64(self._raw(self.keys[:n])).copy(),
                self.cnt[:n].cpu().numpy().copy())

    def hist(self):
        """1024-bin count histogram (yak_ch_hist), int64."""
        self.flush()
        return st.hist(self.cnt, self.size).cpu().numpy()

    def _map_counts(self, value):
        lane = torch.arange(self.cap, device=self.device)
        self.cnt = torch.where(lane < self.size,
                               torch.full_like(self.cnt, value), self.cnt)

    def destroy_bf(self):
        """Drop the Bloom filter (yak_ch_destroy_bf); later folds run
        ungated.  Pending folds are folded through it first."""
        self.flush()
        self.bf = None

    def clear_counts(self):
        """Zero every live count (yak_ch_clear)."""
        self.flush()
        self._map_counts(0)

    def set_counts(self, value):
        """Set every live count to `value` (yak_ch_setcnt)."""
        if not 0 <= value <= YAK_MAX_COUNT:
            raise ValueError(f"count {value} outside [0, {YAK_MAX_COUNT}]")
        self.flush()
        self._map_counts(value)

    def shrink(self, cmin, cmax):
        """Keep entries with count in [cmin, cmax] (yak_ch_shrink)."""
        cmax = cmax if cmin <= cmax <= YAK_MAX_COUNT else YAK_MAX_COUNT
        self.flush()
        with spans.span("table.shrink"):
            keep = (self.cnt >= cmin) & (self.cnt <= cmax)
            self.keys, self.cnt, self.size = st.compact_where(
                self.keys, self.cnt, self.size, keep)
            self._tot = int(self.size)

    def _check_same(self, other, what):
        if (self.k, self.pre, self.device) != (other.k, other.pre,
                                               other.device):
            raise ValueError(
                f"{what}: a table of k={other.k}, pre={other.pre} on "
                f"{other.device} against one of k={self.k}, "
                f"pre={self.pre} on {self.device}")

    def merge(self, other, cmin, cmax):
        """Add one presence vote to each of `other`'s keys whose count is
        in [cmin, cmax], creating the keys this table lacks (yak_ch_merge,
        htab.c:241-285; cntasm).  The selected keys are compacted to an
        ascending batch (unique, INT64_MAX after them) and folded in by
        the merge-reduce in count mode, its counts saturating at 1023;
        the union's capacity is reserved first.

        `other` may be of another k or pre, as in yak_tpu: keys are full
        hashes, and pre only lays out a dump's shards, so the table keeps
        its own k and pre (cntasm -i: the -i table's).  Its raw hashes
        are taken in this table's encoding: wide-encoded into a k >= 32
        table (in order, as a k <= 31 hash is below 2^62), and into a
        k <= 31 one as the raw 64 bits, sorted again (yak_tpu's packed
        merge would drop their top bit; no command merges so)."""
        if self.device != other.device:
            raise ValueError(f"merge: a table on {other.device} against one "
                             f"on {self.device}")
        cmax = cmax if cmin <= cmax <= YAK_MAX_COUNT else YAK_MAX_COUNT
        self.flush()
        other.flush()
        sel = (other.cnt >= cmin) & (other.cnt <= cmax)
        bkeys, _c, _n = st.compact_where(other.keys, other.cnt, other.size,
                                         sel)
        if other.wide != self.wide:
            raw = other._raw(bkeys)
            bkeys = torch.where(bkeys != INT64_MAX,
                                encode_wide(raw) if self.wide else raw,
                                INT64_MAX)
            if other.wide:
                bkeys = torch.sort(bkeys).values
        self._ensure_capacity(self.tot + other.tot)
        okeys, ocnt, new_size, _n_new = merge.merge_reduce(
            self.keys, self.cnt, self.size, bkeys, create=True,
            wide=self.wide)
        self.keys, self.cnt, self.size = okeys, ocnt, new_size
        self._tot = int(new_size)
        if self._tot > self.cap:
            raise RuntimeError(f"merge: {self._tot} keys overflow the "
                               f"reserved capacity {self.cap}")

    def subtract(self, other):
        """Drop the keys present in `other` (yak_ch_subtract)."""
        self._filter_by_membership(other, keep_present=False)

    def isec(self, other):
        """Keep only the keys present in `other` (yak_ch_isec)."""
        self._filter_by_membership(other, keep_present=True)

    def _filter_by_membership(self, other, keep_present):
        """The table's live keys, ascending, are `other`'s queries as they
        are: the lanes at or beyond size (unspecified after a
        merge-reduce) set to INT64_MAX, one JOIN with the identity as
        their lanes and no query sort (where the JOIN is off,
        YAK_TPU_JOIN=0 or YAK_TPU_PALLAS=0, the sorted join
        `sorttable.lookup`, as yak_tpu always takes here); then the
        survivors are compacted in order."""
        self._check_same(other, "subtract/isec")
        self.flush()
        other.flush()
        lane = torch.arange(self.cap, dtype=torch.int32, device=self.device)
        live = lane < self.size
        qkeys = torch.where(live, self.keys, INT64_MAX)
        if countstep.join_enabled():
            vals = merge.merge_join(other.keys, other.cnt, other.size, qkeys,
                                    lane)
        else:   # yak_tpu's own lookup here (yak_tpu/table.py:611-615)
            vals = st.lookup(other.keys, other.cnt, other.size, qkeys)
        present = vals >= 0
        keep = present if keep_present else ~present & live
        self.keys, self.cnt, self.size = st.compact_where(
            self.keys, self.cnt, self.size, keep)
        self._tot = int(self.size)

    def getseq(self):
        """Every live (packed 2-bit k-mer uint64, count) pair, the hashes
        inverted on the host (yak_ch_getseq, htab.c:353-367); k <= 31
        only, as a longer k-mer's hash is not invertible."""
        if self.k > 31:
            raise ValueError(f"getseq: k={self.k}; a table's k-mers can be "
                             f"printed for k <= 31 only")
        h_np, c_np = self.items()
        return hash64_inv(h_np, (1 << (2 * self.k)) - 1), c_np

    # -- state bridge and I/O -------------------------------------------

    def _set_state(self, keys, cnt, n):
        self._pend, self._pend_codes = [], []
        self._pend_lanes, self._last_step = 0, None
        self.keys = u64_to_torch(keys, self.device)
        if self.wide:
            self.keys = encode_wide(self.keys)
        self.cnt = torch.tensor(np.asarray(cnt, np.int32),
                                device=self.device)
        self.size = torch.tensor(n, dtype=torch.int32, device=self.device)
        self._tot = n

    @classmethod
    def from_arrays(cls, keys_u64, cnt_i32, size, k, pre, device):
        """A table holding the state of a `yak_tpu` KmerTable: its keys
        (uint64 [cap], ascending in [0, size)), counts (int32 [cap]) and
        live size, as numpy."""
        keys_u64 = np.asarray(keys_u64, np.uint64)
        cap, size = len(keys_u64), int(size)
        if len(cnt_i32) != cap or not 0 <= size <= cap:
            raise ValueError("from_arrays: keys/cnt lengths differ or "
                             "size exceeds them")
        t = cls(k, pre, cap_log2=max(cap - 1, 1).bit_length(),
                cap_hinted=True, device=device)
        t._set_state(keys_u64, cnt_i32, size)
        return t

    def to_arrays(self):
        """(keys uint64 [cap], cnt int32 [cap], size) as numpy, with the
        lanes beyond size cleared to (0, -1) as in a fresh table."""
        n = self.tot
        keys = np.zeros(self.cap, np.uint64)
        cnt = np.full(self.cap, -1, np.int32)
        keys[:n] = torch_to_u64(self._raw(self.keys[:n]))
        cnt[:n] = self.cnt[:n].cpu().numpy()
        return keys, cnt, n

    def _set_pairs(self, h_np, c_np):
        """Replace contents with unique host (hash, count) pairs."""
        order = np.argsort(h_np, kind="stable")
        h_np, c_np = h_np[order], c_np[order]
        n = len(h_np)
        cap = max(self.cap, 1 << 14)
        while cap < n:
            cap *= 2
        keys = np.zeros(cap, np.uint64)
        cnts = np.full(cap, -1, np.int32)
        keys[:n] = h_np
        cnts[:n] = c_np
        self._set_state(keys, cnts, n)

    def dump(self, path):
        h_np, c_np = self.items()
        yakfmt.dump_yak(path, self.k, self.pre, h_np, c_np)
        _log(f"dumped the hash table to file '{path}'")

    @classmethod
    def restore(cls, path, device, mode=YAK_LOAD_ALL, min_cnt=0, mid_cnt=0,
                into=None):
        """Load a `.yak` file (yak_ch_restore_core semantics with the load
        modes' value transforms) into a new table on `device`, or, with
        `into`, OR its kept (hash, value) pairs into that table, whose k,
        pre and device must agree (the trio and sexchr flag tables).
        The union's capacity is reserved once, then the pairs are
        OR-merged in chunks of 2^22."""
        k, pre, hashes, counts = yakfmt.restore_yak(path)
        vals, keep = yakfmt.apply_load_mode(counts, mode, min_cnt, mid_cnt)
        hashes, vals = hashes[keep], vals[keep].astype(np.int32)
        if into is None:
            t = cls(k, pre, device=device)
            t._set_pairs(hashes, vals)
            return t
        t = into
        if (t.k, t.pre) != (k, pre) or t.device != torch.device(device):
            raise ValueError(
                f"{path}: k={k}, pre={pre} on {device} cannot be restored "
                f"into a table of k={t.k}, pre={t.pre} on {t.device}")
        t._ensure_capacity(t.tot + len(hashes))
        chunk = 1 << 22
        for off in range(0, len(hashes), chunk):
            h = u64_to_torch(hashes[off:off + chunk], t.device)
            if t.wide:
                h = encode_wide(h)
            add = torch.from_numpy(vals[off:off + chunk]).to(t.device)
            valid = torch.ones(h.shape, dtype=torch.bool, device=t.device)
            t.keys, t.cnt, t.size, _, _ = st.merge_batch(
                t.keys, t.cnt, t.size, h, add, valid, create=True,
                mode=st.OR)
        t._tot = int(t.size)
        return t
