"""Error-streak detection (chkerr.c): report runs of consecutive k-mers
with count < min_cnt longer than min_streak.

Reference per-position logic (chkerr.c:55-68): at each extracted k-mer
(end position i) with cnt < min_cnt, extend the streak if i == last+1,
else emit the previous streak (if > min_streak) and restart.  The emitted
row is `name  last+1-k-(streak-1)  last+1  streak`.

Port of `yak_tpu/models/chkerr.py`, its single-device JOIN path with the
marker compaction: per chunk, the lookups (extract, query sort, the
merge-JOIN kernel), the run-end markers and their compaction (the
hand-written compaction kernel) run on the table's device, and only the
markers come back; the host maps marker lanes to sequence positions and
merges runs that span a chunk boundary (`_ChkerrFold`, carried over
unchanged).  With the psort engine (YAK_TPU_PSORT=1,
`countstep.psort_enabled`, read per run) the query sort and the marker
step run through the sort kernel: the markers are sorted by lane, in
place of the compaction (the JAX package's psort branch).  Under
YAK_TPU_MARK_COMPACT=0, YAK_TPU_JOIN=0 or YAK_TPU_PALLAS=0 the markers
come from one torch.sort (`countstep.marker_step`), and under the last
two the lookups from the sorted join (`countstep.lookup_keys`), as the
JAX package's get_chkerr_join_post and get_chkerr_step take them.

A MeshTable (yak_tpu's `_main_chkerr_mesh`, chkerr.py:230-265) takes
the routed lookups of `parallel.mesh.mesh_routed_groups`, and
each chunk's marker mid and compaction (or marker sort) run on the
chunk's device, with the same budget and the same copy of every marker
past it.
"""

import sys
from dataclasses import dataclass

import numpy as np

from yak_tpu_torch.io.pack import pack_chunk_planes
from yak_tpu_torch.ops import countstep
from yak_tpu_torch.parallel.mesh import MeshTable, mesh_lookup_posts
from yak_tpu_torch.utils import (host_markers, lookup_pipeline, settle,
                                 to_host_async)


@dataclass
class ChkerrOpts:
    min_cnt: int = 3
    min_streak: int = 5
    chunk_size: int = 1_000_000_000
    n_threads: int = 8


def main_chkerr(opt, table, seq_fn, out=None):
    """Device fold with a 2-deep dispatch pipeline: chunk i's device work
    is queued before the host streak pass of chunk i-1, whose markers
    were copied to the host behind an event of their own (no wait for
    chunk i).  Only the first CHKERR_MAX_RUNS markers are copied ahead;
    a chunk with more copies all of them from its compacted planes,
    which stay on the device until the chunk is folded.  A MeshTable
    takes its routed lookups (module note)."""
    out = out or sys.stdout
    k = table.k
    table.flush()
    chunk = max(1 << 14, min(int(opt.chunk_size), 1 << 23))
    chunk = -(-chunk // 1024) * 1024
    M = chunk - k + 1
    fold = _ChkerrFold(opt, k, out)
    psort = countstep.psort_enabled()
    mark = countstep.marker_step(psort)
    maxr = countstep.CHKERR_MAX_RUNS

    def post(_packed, vals, valid):
        khi, runlen, n = countstep.chkerr_mark_mid(vals, valid,
                                                   int(opt.min_cnt), M)
        planes = mark(khi, runlen)
        return planes, to_host_async((n, planes[0][:maxr], planes[1][:maxr]))

    if isinstance(table, MeshTable):
        # yak_tpu's _main_chkerr_mesh: a post a chunk on its own device
        stream = mesh_lookup_posts(seq_fn, table, chunk, post, psort=psort)
    else:
        def dispatch(packed):
            carg = pack_chunk_planes(packed, table.device)
            vals, valid = countstep.lookup_chunk(carg, k, table.keys,
                                                 table.cnt, table.size,
                                                 psort=psort)
            return post(packed, vals, valid)
        stream = lookup_pipeline(seq_fn, chunk, k, dispatch)
    for packed, (planes, host) in stream:
        # past the budget (a low-coverage table against a large input)
        # the compacted planes on the device hold every marker
        lanes, lens = host_markers(planes, *settle(host), maxr)
        fold.chunk(packed, lanes, lens, M)
    fold.finish()


class _ChkerrFold:
    """Host side of the chkerr device fold: maps marker lanes to
    sequence positions and merges runs spanning chunk boundaries
    (chkerr.c:55-68)."""

    def __init__(self, opt, k, out):
        self.opt, self.k, self.out = opt, k, out
        self.carry = None   # (name, gi, streak, end_pos) open run

    def emit(self, name, streak, endpos):
        if streak > self.opt.min_streak:
            k = self.k
            self.out.write(f"{name}\t{endpos + 1 - k - (streak - 1)}\t"
                           f"{endpos + 1}\t{streak}\n")

    def chunk(self, packed, lanes, lens, M):
        nseq = len(packed.rec_gid)
        n = len(lanes)
        starts = np.minimum(packed.rec_start, M)
        seg_of = np.searchsorted(starts, lanes, side="right") - 1
        continues = (int(packed.rec_off0[-1] + packed.rec_take[-1])
                     < int(packed.rec_len[-1]))
        ws0 = int(starts[0])
        # last window lane of the final piece (piece windows are
        # [start, start + take - k] inclusive)
        we = int(packed.rec_start[-1] + packed.rec_take[-1] - self.k)

        if self.carry is not None:
            name_c, gi_c, streak_c, end_c = self.carry
            self.carry = None
            if (n > 0 and int(seg_of[0]) == 0
                    and int(lanes[0] - lens[0] + 1) == ws0
                    and int(packed.rec_gid[0]) == gi_c):
                lens[0] += streak_c   # merged across the chunk boundary
            else:
                self.emit(name_c, streak_c, end_c)

        for i in range(n):
            j = int(seg_of[i])
            gi = int(packed.rec_gid[j])
            endpos = (int(lanes[i]) - int(starts[j])
                      + int(packed.rec_off0[j]) + self.k - 1)
            streak = int(lens[i])
            if continues and j == nseq - 1 and int(lanes[i]) == we:
                self.carry = (packed.seq_names[gi], gi, streak, endpos)
            else:
                self.emit(packed.seq_names[gi], streak, endpos)

    def finish(self):
        if self.carry is not None:
            name_c, _gi, streak_c, end_c = self.carry
            self.emit(name_c, streak_c, end_c)
            self.carry = None
