"""Trio binning (triobin.c) and phasing evaluation (trioeval.c).

Both load pat/mat tables as 2-bit class flags (TRIOBIN1/2 load modes,
htab.c:449-461), stream the child sequences, and type each position:
  flag = table value (0 if absent); c1 = flag&3 (pat class), c2 = flag>>2&3
  type 1 (pat-strong) if c1==2 && c2==0; type 2 (mat-strong) if c2==2 && c1==0
then run streak logic over the per-position type array:
  triobin:  nonzero-type streaks >= k-4 accumulate sc[type-1] bases,
            then tb_classify -> p/m/a/0 (triobin.c:94-121)
  trioeval: nonzero-type streaks >= min_n sites become phase-block
            elements; count switch pairs and sites (trioeval.c:91-117)

Port of `yak_tpu/models/trio.py`, its single-device JOIN path.  Per
chunk, on the table's device: the lookups (extract, query sort, the
merge-JOIN kernel), the typing and, for triobin, the eight per-contig
segment sums and the boundary-run scalars (`countstep.triobin_reduce`),
for `-p` the difference markers, for trioeval the run markers; the
markers are compacted by the compaction kernel, or, under the psort
engine (YAK_TPU_PSORT=1, `countstep.psort_enabled`, read per run),
sorted by lane through the sort kernel, which also takes the query
sort; under YAK_TPU_MARK_COMPACT=0, YAK_TPU_JOIN=0 or YAK_TPU_PALLAS=0
by one torch.sort (`countstep.marker_step`), the JAX package's
full-lane marker sort, and under the last two the lookups take the
sorted join (`countstep.lookup_keys`).  Only the sums and the markers
come back.  The host folds
(`_TriobinFold`, `_TeChainFold`, `_TeSeq`), the classifier and the
output interleaving (`_BatchedOut`) are the JAX package's host code,
carried over (the -p rows are formatted from Python ints).

A chunk with more markers than its budget (TRIOBIN_MAX_DIFF,
TRIOEVAL_MAX_RUNS) copies all of them from its compacted planes, which
stay on the device until the chunk is folded; the JAX package's
per-position fallback exists because its marker planes are cut to the
budget.

A MeshTable takes the mesh paths (yak_tpu's
`_main_triobin_fused_mesh` and `_trioeval_fused_mesh`,
yak_tpu/models/trio.py:394-574, 765-812): the routed lookups of
`parallel.mesh.mesh_routed_groups`, then each chunk's typing,
reductions and markers on the chunk's own device
(`parallel.mesh.mesh_lookup_posts`), folded by the same host code.
"""

import sys
from dataclasses import dataclass

import numpy as np
import torch

from yak_tpu_torch import YAK_LOAD_TRIOBIN1, YAK_LOAD_TRIOBIN2
from yak_tpu_torch.io.pack import pack_chunk_planes
from yak_tpu_torch.ops import countstep
from yak_tpu_torch.parallel.mesh import MeshTable, mesh_lookup_posts
from yak_tpu_torch.table import KmerTable
from yak_tpu_torch.utils import (host_markers, lookup_pipeline, settle,
                                 to_host_async)

NO_KMER = -2   # the scan value of a window with an N (models/scan.py:29)


@dataclass
class TrioOpts:
    min_cnt: int = 2
    mid_cnt: int = 5
    n_threads: int = 8
    ratio_thres: float = 0.33   # triobin -r
    min_n: int = 2              # trioeval -n
    print_diff: bool = False    # triobin -p
    print_err: bool = False     # trioeval -e
    print_frag: bool = True     # trioeval (off with -F)


def load_trio_tables(pat_fn, mat_fn, opt, device):
    ch = KmerTable.restore(pat_fn, device, mode=YAK_LOAD_TRIOBIN1,
                           min_cnt=opt.min_cnt, mid_cnt=opt.mid_cnt)
    return KmerTable.restore(mat_fn, device, mode=YAK_LOAD_TRIOBIN2,
                             min_cnt=opt.min_cnt, mid_cnt=opt.mid_cnt,
                             into=ch)


def _types_and_flags(vals):
    """Per-position flag and type arrays from the scan value stream
    (numpy; the host model of `countstep.trio_types`)."""
    is_k = vals != NO_KMER
    flag = np.where(is_k, np.maximum(vals, 0), 0).astype(np.int32)
    c1 = flag & 3
    c2 = (flag >> 2) & 3
    typ = np.zeros(len(vals), np.int32)
    typ[is_k & (c1 == 2) & (c2 == 0)] = 1
    typ[is_k & (c2 == 2) & (c1 == 0)] = 2
    return is_k, flag, typ


def tb_classify_vec(sc0, sc1, P, M, k, ratio_thres):
    """Vectorized tb_classify over per-contig arrays (same branch order
    and float arithmetic as the scalar port below)."""
    sc0 = sc0.astype(np.int64)
    sc1 = sc1.astype(np.int64)
    P = P.astype(np.int64)
    M = M.astype(np.int64)
    no_sc = (sc0 == 0) & (sc1 == 0)
    p1 = no_sc & (P != M) & (P >= k - 4 + M) & ((M <= 1) | (P * 0.05 > M))
    m1 = no_sc & (P != M) & (M >= k - 4 + P) & ((P <= 1) | (M * 0.05 > P))
    a2 = ~no_sc & (sc0 > k) & (sc1 > k)
    p2 = (~no_sc & (sc0 >= k - 4 + sc1) & (sc0 * 0.05 >= sc1)
          & (P * ratio_thres > M))
    m2 = (~no_sc & (sc1 >= k - 4 + sc0) & (sc1 * 0.05 >= sc0)
          & (M * ratio_thres > P))
    return np.select(
        [p1, m1, no_sc, a2, p2, m2],
        ["p", "m", "0", "a", "p", "m"], default="a")


def tb_classify(sc, c, k, ratio_thres):
    """Contig classification (tb_classify, triobin.c:103-121)."""
    P, M = c[0 << 2 | 2], c[2 << 2 | 0]
    if sc[0] == 0 and sc[1] == 0:
        if P == M:
            return "0"
        if P >= k - 4 + M and (M <= 1 or P * 0.05 > M):
            return "p"
        if M >= k - 4 + P and (P <= 1 or M * 0.05 > P):
            return "m"
        return "0"
    if sc[0] > k and sc[1] > k:
        return "a"
    if sc[0] >= k - 4 + sc[1] and sc[0] * 0.05 >= sc[1] and P * ratio_thres > M:
        return "p"
    if sc[1] >= k - 4 + sc[0] and sc[1] * 0.05 >= sc[0] and M * ratio_thres > P:
        return "m"
    return "a"


class _BatchedOut:
    """Reproduce the reference's output interleaving: per input batch
    (bseq_read of `batch_bases`), all worker-emitted rows print first
    (during kt_for), then the per-sequence summary rows (pipeline step 1
    loop) — triobin.c:136-148, trioeval.c:132-149."""

    def __init__(self, out, batch_bases):
        self.out = out
        self.batch_bases = batch_bases
        self.worker_rows = []
        self.summary_rows = []
        self.cum = 0

    def add(self, worker_text, summary_text, seq_len):
        self.worker_rows.append(worker_text)
        self.summary_rows.append(summary_text)
        self.cum += seq_len
        if self.cum >= self.batch_bases:
            self.flush()

    def flush(self):
        self.out.write("".join(self.worker_rows))
        self.out.write("".join(self.summary_rows))
        self.worker_rows, self.summary_rows, self.cum = [], [], 0


def _emit_triobin_row(bo, opt, k, name, L, s, wtext=""):
    """s = [nk, c0, c1, c2, c4, c8, sc1, sc2] accumulated for one seq."""
    c = np.zeros(16, np.int64)
    c[[0, 1, 2, 4, 8]] = s[1:6]
    sc = [int(s[6]), int(s[7])]
    t = tb_classify(sc, c, k, opt.ratio_thres)
    bo.add(wtext, (f"{name}\t{t}\t{sc[0]}\t{sc[1]}\t{c[2]}\t{c[8]}\t"
                   f"{c[1]}\t{c[4]}\t{int(s[0])}\t{c[0]}\n"), L)


_D_TAIL = [f"\t{f & 3}\t{f >> 2}\n" for f in range(16)]


class _TriobinFold:
    """Host side of the triobin device fold: merges boundary streaks
    (and -p D rows) across chunk-spanning pieces and emits the report
    rows."""

    def __init__(self, opt, k, bo):
        self.opt, self.k, self.bo = opt, k, bo
        self.carry = None  # [gi, sums(8), open_typ, open_len, nm, L, dtxt]

    def _close(self, sums, typ, length):
        if typ > 0 and length >= self.k - 4:
            sums[5 + typ] += length

    def chunk(self, packed, S, scal4, d_txt, M):
        """One chunk's fetched outputs: S [nseq, 8] i64 per-seg sums,
        scal4 the boundary-run scalars, d_txt per-seg -p row text."""
        opt, k, bo, close = self.opt, self.k, self.bo, self._close
        nseq = len(packed.rec_gid)
        we = int(packed.rec_start[-1] + packed.rec_take[-1] - k)
        h_typ, h_len, t_typ, t_len = (int(x) for x in scal4)
        continues = (int(packed.rec_off0[-1] + packed.rec_take[-1])
                     < int(packed.rec_len[-1]))
        single = h_len == we + 1

        # boundary-run fixup for the first and last segments (scalar);
        # everything else is already complete in S
        g0 = int(packed.rec_gid[0])
        o_typ, o_len = 0, 0
        if self.carry is not None:
            assert self.carry[0] == g0
            S[0] += self.carry[1]
            o_typ, o_len = self.carry[2], self.carry[3]
            d_txt[0] = self.carry[6] + d_txt[0]
            self.carry = None
        open_out = None
        if single and nseq == 1:
            # head and tail are the same run spanning the piece
            if o_typ > 0 and o_typ == h_typ:
                run = (h_typ, o_len + h_len)
            else:
                close(S[0], o_typ, o_len)
                run = (h_typ, h_len)
            if continues:
                open_out = run
            else:
                close(S[0], *run)
        else:
            if o_typ > 0 and o_typ == h_typ:
                close(S[0], h_typ, o_len + h_len)
            else:
                close(S[0], o_typ, o_len)
                close(S[0], h_typ, h_len)
            if continues:
                open_out = (t_typ, t_len)
            else:
                close(S[-1], t_typ, t_len)
        if continues:
            gi_c = int(packed.rec_gid[-1])
            self.carry = [gi_c, S[-1],
                          open_out[0] if open_out else 0,
                          open_out[1] if open_out else 0,
                          packed.seq_names[gi_c],
                          int(packed.rec_len[-1]), d_txt[-1]]

        # vectorized classify + row formatting for all completed segs
        j_hi = nseq - 1 if continues else nseq
        if j_hi > 0:
            sub = S[:j_hi]
            t_arr = tb_classify_vec(sub[:, 6], sub[:, 7], sub[:, 3],
                                    sub[:, 5], k, opt.ratio_thres)
            names = [packed.seq_names[int(g)]
                     for g in packed.rec_gid[:j_hi]]
            cols = [c.tolist() for c in
                    (sub[:, 6], sub[:, 7], sub[:, 3], sub[:, 5],
                     sub[:, 2], sub[:, 4], sub[:, 0], sub[:, 1],
                     packed.rec_len[:j_hi])]
            rows = [f"{nm}\t{tv}\t{a}\t{b}\t{cP}\t{cM}\t{c1_}\t"
                    f"{c4_}\t{nk}\t{c0_}\n"
                    for nm, tv, a, b, cP, cM, c1_, c4_, nk, c0_, _L in
                    zip(names, t_arr, *cols)]
            bo.add("".join(d_txt[:j_hi]), "".join(rows),
                   int(np.sum(packed.rec_len[:j_hi])))

    def build_d_txt(self, packed, dlanes, dflag, M):
        """Per-segment -p D-row text from decoded difference markers
        (flags in [0, 16): each row's tail is one of 16 strings)."""
        k = self.k
        nseq = len(packed.rec_gid)
        starts_np = np.minimum(packed.rec_start, M)
        dseg = np.searchsorted(starts_np, dlanes, side="right") - 1
        dbnd = np.concatenate(
            [np.searchsorted(dseg, np.arange(nseq)), [len(dlanes)]]).tolist()
        lanes, flags = dlanes.tolist(), dflag.tolist()
        d_txt = []
        for j in range(nseq):
            head = f"D\t{packed.seq_names[int(packed.rec_gid[j])]}\t"
            base = (int(packed.rec_off0[j]) - int(starts_np[j]) + k - 1)
            a, b = dbnd[j], dbnd[j + 1]
            d_txt.append("".join([head + str(l + base) + _D_TAIL[f]
                                  for l, f in zip(lanes[a:b], flags[a:b])]))
        return d_txt

    def finish(self):
        if self.carry is not None:
            # unreachable with the current packer (a continuing record
            # always yields a following chunk), but emit the REAL name
            # and length if a future packer ends the stream mid-carry
            self._close(self.carry[1], self.carry[2], self.carry[3])
            _emit_triobin_row(self.bo, self.opt, self.k, self.carry[4],
                              self.carry[5], self.carry[1],
                              wtext=self.carry[6])
        self.bo.flush()


def _stream(seq_fn, table, chunk, post, psort):
    """(packed, post(packed, vals, valid)) for each chunk of `seq_fn` with
    records: one device, the chunk's lookup (`countstep.lookup_chunk`)
    and post in the 2-deep pipeline; a MeshTable, the mesh path's
    routed lookups, each post on its chunk's device."""
    if isinstance(table, MeshTable):
        return mesh_lookup_posts(seq_fn, table, chunk, post, psort=psort)

    def dispatch(packed):
        carg = pack_chunk_planes(packed, table.device)
        vals, valid = countstep.lookup_chunk(carg, table.k, table.keys,
                                             table.cnt, table.size,
                                             psort=psort)
        return post(packed, vals, valid)
    return lookup_pipeline(seq_fn, chunk, table.k, dispatch)


def _chunk_len(batch_bases, chunk_cap):
    chunk = max(1 << 14, min(batch_bases, chunk_cap))
    return -(-chunk // 1024) * 1024


def main_triobin(opt, table, seq_fn, out=None, chunk_cap=1 << 23,
                 batch_bases=200_000_000):
    """The `triobin` command body (triobin.c:41-148): per chunk, the
    lookups, the typing and the per-contig sums on the table's device
    (`countstep.triobin_reduce`), with -p the difference markers; the
    host merges boundary streaks across chunk-spanning pieces and
    classifies.  A MeshTable takes the mesh path (module note)."""
    out = out or sys.stdout
    k = table.k
    table.flush()
    chunk = _chunk_len(batch_bases, chunk_cap)
    M = chunk - k + 1
    emit_diff = bool(opt.print_diff)
    fold = _TriobinFold(opt, k, _BatchedOut(out, batch_bases))
    psort = countstep.psort_enabled()
    mark = countstep.marker_step(psort, diff=True)
    maxd = countstep.TRIOBIN_MAX_DIFF

    def post(packed, vals, valid):
        nseq = len(packed.rec_gid)
        ns = max(1 << 12, 1 << int(max(nseq - 1, 1)).bit_length())
        meta = np.full(ns + 2, M, np.int32)
        meta[:nseq] = np.minimum(packed.rec_start, M)
        meta[-1] = int(packed.rec_start[-1] + packed.rec_take[-1] - k)
        flag, typ = countstep.trio_types(vals, valid)
        sums = countstep.triobin_reduce(
            flag, typ, valid, torch.from_numpy(meta).to(vals.device), k, M)
        if not emit_diff:
            return ns, None, to_host_async((sums,))
        khi, pay, n = countstep.triobin_diff_mid(flag, valid, M)
        planes = mark(khi, pay)
        return ns, planes, to_host_async(
            (sums, n, planes[0][:maxd], planes[1][:maxd]))

    for packed, (ns, planes, host) in _stream(seq_fn, table, chunk, post,
                                              psort):
        nseq = len(packed.rec_gid)
        host = settle(host)
        d_txt = [""] * nseq
        if emit_diff:
            dlanes, dflag = host_markers(planes, *host[1:], maxd)
            d_txt = fold.build_d_txt(packed, dlanes, dflag, M)
        r = host[0].numpy()
        S = r[:8 * ns].reshape(8, ns)[:, :nseq].T.astype(np.int64)
        fold.chunk(packed, S, r[8 * ns:], d_txt, M)
    fold.finish()


TRIOEVAL_HEADER = (
    "C\tS  seqName     #patKmer  #matKmer  #pat-pat  #pat-mat  #mat-pat  "
    "#mat-mat  seqLen\n"
    "C\tF  seqName     type      startPos  endPos    count\n"
    "C\tW  #switchErr  denominator  switchErrRate\n"
    "C\tH  #hammingErr denominator  hammingErrRate\n"
    "C\tN  #totPatKmer #totMatKmer  errRate\n"
    "C\n")


class _TeSeq:
    """Per-sequence trioeval chain state: the exact per-qualifying-run
    body of te_worker (trioeval.c:91-117) — pair counts c[4], site
    counts d[2], the `last` phase link, fragment tracking (F rows), and
    error rows (E rows).  Positions are vals-array coordinates (the
    k-mer END base index)."""

    __slots__ = ("name", "L", "opt", "k", "c", "d", "last",
                 "f_type", "f_st", "f_en", "f_cnt", "wrows")

    def __init__(self, name, L, opt, k):
        self.name, self.L, self.opt, self.k = name, L, opt, k
        self.c = [0, 0, 0, 0]
        self.d = [0, 0]
        self.last = 0
        self.f_type = self.f_st = self.f_en = self.f_cnt = 0
        self.wrows = []

    def run(self, st, ln, tv):
        """One qualifying run (tv > 0, ln >= min_n)."""
        n = (int(ln) + self.k - 1) // self.k
        cc = int(tv) - 1
        self.c[cc << 1 | cc] += n - 1
        self.d[cc] += n
        if self.last > 0:
            self.c[(self.last - 1) << 1 | cc] += 1
            if self.opt.print_err and self.last - 1 != cc:
                self.wrows.append(f"E\t{self.name}\t{st + ln}\t"
                                  f"{self.last}\t{cc + 1}\n")
        if self.f_type != tv:
            if self.f_type > 0 and self.opt.print_frag:
                self.wrows.append(
                    f"F\t{self.name}\t{self.f_type}\t{self.f_st}\t"
                    f"{self.f_en}\t{self.f_cnt}\n")
            self.f_type, self.f_st, self.f_cnt = \
                int(tv), int(st) + 1 - self.k, 0
        self.f_cnt += 1
        self.f_en = int(st + ln) + 1  # trioeval.c:109: f_en = i + 1
        self.last = int(tv)

    def finish(self, bo, glob):
        """Flush the open fragment, emit the S row, fold the global
        switch/hamming accumulators (trioeval.c:132-149, 195-209)."""
        if self.f_type > 0 and self.opt.print_frag:
            self.wrows.append(f"F\t{self.name}\t{self.f_type}\t"
                              f"{self.f_st}\t{self.f_en}\t{self.f_cnt}\n")
        c, d = self.c, self.d
        glob["n_par0"] += d[0]
        glob["n_par1"] += d[1]
        if d[0] + d[1] >= 2:
            glob["n_pair"] += c[0] + c[1] + c[2] + c[3]
            glob["n_switch"] += c[1] + c[2]
            glob["n_site"] += d[0] + d[1]
            glob["n_err"] += min(d[0], d[1])
        bo.add("".join(self.wrows),
               f"S\t{self.name}\t{d[0]}\t{d[1]}\t{c[0]}\t{c[1]}\t"
               f"{c[2]}\t{c[3]}\t{self.L}\n", self.L)


def main_trioeval(opt, table, seq_fn, out=None, chunk_cap=1 << 23,
                  batch_bases=1_000_000_000):
    """Phase-block switch statistics (te_worker + summary,
    trioeval.c:91-117,195-209): per chunk, the lookups, the typing and
    the run markers on the table's device; the host replays the
    per-run chain (`_TeChainFold`).  A MeshTable takes the mesh path
    (module note)."""
    out = out or sys.stdout
    k = table.k
    table.flush()
    chunk = _chunk_len(batch_bases, chunk_cap)
    M = chunk - k + 1
    glob = {"n_pair": 0, "n_site": 0, "n_switch": 0, "n_err": 0,
            "n_par0": 0, "n_par1": 0}
    out.write(TRIOEVAL_HEADER)
    bo = _BatchedOut(out, batch_bases)
    fold = _TeChainFold(opt, k, bo, glob)
    psort = countstep.psort_enabled()
    mark = countstep.marker_step(psort)
    maxr = countstep.TRIOEVAL_MAX_RUNS

    def post(packed, vals, valid):
        we = int(packed.rec_start[-1] + packed.rec_take[-1] - k)
        _flag, typ = countstep.trio_types(vals, valid)
        khi, pay, n = countstep.trioeval_mark_mid(typ, we, int(opt.min_n), M)
        planes = mark(khi, pay)
        return we, planes, to_host_async(
            (n, planes[0][:maxr], planes[1][:maxr]))

    for packed, (we, planes, host) in _stream(seq_fn, table, chunk, post,
                                              psort):
        lanes, pays = host_markers(planes, *settle(host), maxr)
        fold.chunk(packed, lanes, pays >> 2, pays & 3, M, we)
    fold.finish()
    bo.flush()
    n_switch, n_pair = glob["n_switch"], glob["n_pair"]
    n_err, n_site = glob["n_err"], glob["n_site"]
    n_par = [glob["n_par0"], glob["n_par1"]]
    out.write(f"W\t{n_switch}\t{n_pair}\t{_fdiv(n_switch, n_pair)}\n")
    out.write(f"H\t{n_err}\t{n_site}\t{_fdiv(n_err, n_site)}\n")
    out.write(f"N\t{n_par[0]}\t{n_par[1]}\t"
              f"{_fdiv(min(n_par[0], n_par[1]), n_par[0] + n_par[1])}\n")


def _host_te_markers(typ, we, min_n):
    """The device step's sparse run markers recomputed on host from a
    per-lane type stream (the numpy model of
    `countstep.trioeval_mark_mid`)."""
    lane = np.arange(len(typ), dtype=np.int64)
    startm = np.concatenate([[True], typ[1:] != typ[:-1]])
    run_start = np.maximum.accumulate(np.where(startm, lane, -1))
    runlen = lane - run_start + 1
    is_end = np.concatenate([typ[:-1] != typ[1:], [True]])
    emit = is_end & (typ > 0) & ((runlen >= min_n)
                                 | (run_start == 0)
                                 | (lane == we))
    return lane[emit], runlen[emit], typ[emit].astype(np.int64)


class _TeChainFold:
    """Host side of the trioeval device fold: maps sparse run markers
    to per-sequence runs, merges boundary runs across chunk-spanning
    pieces, and replays the phase chain (trioeval.c:91-117)."""

    def __init__(self, opt, k, bo, glob):
        self.opt, self.k, self.bo, self.glob = opt, k, bo, glob
        self.carry = None  # (gi, _TeSeq, open_run (typ, len, end_pos))

    def chunk(self, packed, lanes, lens, typs, M, we):
        opt, k, bo, glob = self.opt, self.k, self.bo, self.glob
        carry = self.carry
        nseq = len(packed.rec_gid)
        starts = np.minimum(packed.rec_start, M)
        seg_of = np.searchsorted(starts, lanes, side="right") - 1
        continues = (int(packed.rec_off0[-1] + packed.rec_take[-1])
                     < int(packed.rec_len[-1]))

        bnd = np.concatenate([np.searchsorted(seg_of, np.arange(nseq)),
                              [len(lanes)]])
        for j in range(nseq):
            gi = int(packed.rec_gid[j])
            l_j = lanes[bnd[j]:bnd[j + 1]]
            n_j = lens[bnd[j]:bnd[j + 1]]
            t_j = typs[bnd[j]:bnd[j + 1]]
            # run start in vals-array coords (k-mer end base index)
            base = int(packed.rec_off0[j]) - int(starts[j]) + k - 1
            runs = [(int(l) + base - int(ln) + 1, int(ln), int(tv))
                    for l, ln, tv in zip(l_j, n_j, t_j)]
            if j == 0 and carry is not None:
                assert carry[0] == gi
                ts, open_run = carry[1], carry[2]
                carry = None
                if open_run is not None:
                    o_tv, o_ln, o_end = open_run
                    if runs and runs[0][0] == o_end + 1 \
                            and runs[0][2] == o_tv:
                        st0, ln0, tv0 = runs[0]
                        runs[0] = (st0 - o_ln, ln0 + o_ln, tv0)
                    else:
                        runs.insert(0, (o_end - o_ln + 1, o_ln, o_tv))
            else:
                ts = _TeSeq(packed.seq_names[gi],
                            int(packed.rec_len[j]), opt, k)
            tail_open = None
            if j == nseq - 1 and continues and runs \
                    and runs[-1][0] - base + runs[-1][1] - 1 == we:
                st_l, ln_l, tv_l = runs.pop()
                tail_open = (tv_l, ln_l, st_l + ln_l - 1)
            for st, ln, tv in runs:
                if ln >= opt.min_n:
                    ts.run(st, ln, tv)
            if j == nseq - 1 and continues:
                carry = (gi, ts, tail_open)
            else:
                ts.finish(bo, glob)
        self.carry = carry

    def finish(self):
        if self.carry is None:
            return
        opt, k, bo, glob = self.opt, self.k, self.bo, self.glob
        _gi, ts, open_run = self.carry
        self.carry = None
        if open_run is not None:
            o_tv, o_ln, o_end = open_run
            if o_ln >= opt.min_n:
                ts.run(o_end - o_ln + 1, o_ln, o_tv)
        ts.finish(bo, glob)


def _div(a, b):
    # C double division: 0/0 -> nan, x/0 -> inf; %.6f of nan prints below
    if b == 0:
        return float("nan") if a == 0 else float("inf")
    return a / b


def _fdiv(a, b):
    """%.6f of the C division — x86 0.0/0.0 is the NEGATIVE quiet NaN,
    which glibc printf renders as '-nan' (trioeval.c's W/H/N lines on
    empty denominators); Python's format drops the sign."""
    if b == 0 and a == 0:
        return "-nan"
    return f"{_div(a, b):.6f}"
