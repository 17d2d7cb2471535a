"""Assembly/read QV estimation (qv.c) and the empirical QV model
(yak_qv_solve, qv.c:146-244 + the gjdn solver, 6gjdn.c).

Port of `yak_tpu/models/qv.py`, its single-device JOIN path: per chunk,
the k-mer lookups (extract, query sort, the merge-JOIN kernel) and the
whole per-sequence reduction and histogram fold run on the table's
device (`ops/countstep.lookup_chunk`, `qv_join_post`); without -p and -E
no value comes back to the host until the end.  The per-sequence
gating of chunk-spanning sequences, the SQ/EK text and the float64
model fit stay on the host (numpy, carried over unchanged).

With the psort engine (YAK_TPU_PSORT=1, `countstep.psort_enabled`, read
per run) the query sort and, without -E, the post's region-key sort run
through the sort kernel (`run_join_lookup`'s and
`run_qv_join_post_psort`'s sorts); with -E the default post stays, as
in the JAX package.

On a `parallel.mesh.MeshTable` (`_run_qv_fused_mesh`) each group of
chunks takes the routed lookup (`parallel.mesh.mesh_routed_groups`) in
place of `lookup_chunk`; the post, the carry and the host text are the
same, the carry following each chunk to its shard's device, so the
output is the same bytes, -p and -E lines included (`yak_tpu` takes its
per-position scan path for -E on a mesh).

YAK_TPU_QV_SEG=1 takes the seg-payload join post on one device for
k <= 31 without -E, where the JOIN runs (`countstep.qv_lookup_seg`,
`qv_join_post_seg`: the JOIN's values in key order beside their
segment ids, then one sort restores the grouping, not the order).

Not ported: the per-position scan path (`_run_qv_scan`), which
`yak_tpu` takes for -E on a mesh and for its `scan=` argument; the
fused fold above serves both here.
"""

import math
import os
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from yak_tpu_torch import YAK_N_COUNTS, spans
from yak_tpu_torch.io.chunks import ChunkSource
from yak_tpu_torch.io.pack import pack_chunk_planes
from yak_tpu_torch.ops import countstep
from yak_tpu_torch.parallel.mesh import MeshTable, mesh_routed_groups
from yak_tpu_torch.utils import Progress

_Q = 4.3429448190325175  # 10 / ln 10


def _log(x):
    """IEEE log like C's: log(0) = -inf, log(<0) = nan, no exceptions."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.log(np.float64(x)))


def _solve_full_pivot(A, B):
    """Solve A x = B by Gauss-Jordan with full pivoting, the same pivot
    strategy as the reference's solver (6gjdn.c) so results — including
    inf/nan propagation on degenerate fits — follow the same arithmetic
    path.  A: (n, n), B: (n,); both modified in place; returns B (= x)."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    n = A.shape[0]
    col_swaps = []
    for k in range(n):
        sub = np.abs(A[k:, k:])
        # C's strict `t > d` never selects NaN entries and starts from 0.0
        sub_c = np.where(np.isnan(sub), -1.0, sub)
        flat = int(np.argmax(sub_c))  # first max, row-major, like the 2 loops
        pr, pc = k + flat // (n - k), k + flat % (n - k)
        d = max(float(sub_c[flat // (n - k), flat % (n - k)]), 0.0)
        if d + 1.0 == 1.0:
            # reference gjdn bails here but its caller ignores the return
            # value (qv.c:220) and keeps the partially transformed B
            print("ERROR: fail", file=sys.stderr)
            return B
        col_swaps.append(pc)
        if pc != k:
            A[:, [k, pc]] = A[:, [pc, k]]
        if pr != k:
            A[[k, pr], k:] = A[[pr, k], k:]
            B[[k, pr]] = B[[pr, k]]
        d = A[k, k]
        A[k, k + 1:] /= d
        B[k] /= d
        for j in range(k + 1, n):
            for i in range(n):
                if i != k:
                    A[i, j] -= A[i, k] * A[k, j]
        for i in range(n):
            if i != k:
                B[i] -= A[i, k] * B[k]
    for k in range(n - 1, -1, -1):
        if col_swaps[k] != k:
            B[[k, col_swaps[k]]] = B[[col_swaps[k], k]]
    return B


@dataclass
class QvOpts:
    """Defaults per yak_qopt_init (qv.c:137-144)."""
    print_each: bool = False
    print_err_kmer: bool = False
    min_len: int = 0
    n_threads: int = 4
    min_frac: float = 0.5
    fpr: float = 0.00004
    chunk_size: int = 1_000_000_000


@dataclass
class QStat:
    tot: int = 0
    qv_raw: float = -1.0
    qv: float = -1.0
    cov: float = 0.0
    err: float = 0.0
    fpr_lower: float = 0.0
    fpr_upper: float = 0.0
    adj_cnt: np.ndarray = field(
        default_factory=lambda: np.zeros(YAK_N_COUNTS))


def run_qv(opt, fn, table, out=None):
    """Stream `fn` against `table`; returns the global occurrence-count
    vector cnt[1024] (yak_qv, qv.c:116-135).  SQ/EK lines go to `out`.

    The device-resident fold of `yak_tpu`'s `_run_qv_fused` JOIN path:
    the accumulation (per-seg reductions, min_frac gating, the
    spanning-sequence carry, the global histogram) stays on the table's
    device; -p and -E fetch the per-seg scalars and the error-k-mer
    markers of each chunk.  `table` may be a MeshTable (module note)."""
    out = out or sys.stdout
    k = table.k
    table.flush()
    dev = table.mesh[0] if isinstance(table, MeshTable) else table.device
    chunk = max(1 << 14, min(int(opt.chunk_size), 1 << 23))
    chunk = -(-chunk // 1024) * 1024
    M = chunk - k + 1
    state = (torch.zeros(YAK_N_COUNTS, dtype=torch.int64, device=dev),
             torch.tensor(-1, dtype=torch.int32, device=dev),
             torch.tensor(0, dtype=torch.int32, device=dev),
             torch.zeros(YAK_N_COUNTS, dtype=torch.int64, device=dev))
    h_carry = [0, 0]           # host mirror of (tot, non0) for -p
    blocks = []                # per-seq output text, input order
    carry_ek = [""]            # EK rows of the chunk-spanning seq
    want_ek = bool(opt.print_err_kmer)
    psort = countstep.psort_enabled()
    # the seg-payload join post (yak_tpu/models/qv.py:416-440): with the
    # JOIN, on one device, k <= 31, without -E
    seg = (os.environ.get("YAK_TPU_QV_SEG", "0") == "1"
           and countstep.join_enabled() and not want_ek and k <= 31
           and not isinstance(table, MeshTable))
    prog = Progress("run_qv")

    for packed, vals, valid, meta_d, info, ns in _qv_lookups(
            fn, table, chunk, M, opt.min_len, psort, seg):
        nseq = len(packed.rec_gid)
        # the carry follows the chunks to their shards' devices
        state = tuple(t.to(vals.device) for t in state)
        with spans.span("qv.post"):
            if seg:    # `valid` holds each sorted value's segment
                outs = countstep.qv_join_post_seg(vals, valid, meta_d, state,
                                                  ns, M, float(opt.min_frac))
            else:
                outs = countstep.qv_join_post(vals, valid, meta_d, state, ns,
                                              M, float(opt.min_frac), want_ek,
                                              psort=psort and not want_ek)
        state = outs[:4]

        ek_txt = None
        if want_ek:
            # sparse 0-count markers -> per-seq EK rows (qv.c:62-64); past
            # the budget, the chunk's per-lane values already on the
            # device give the same lanes
            nz = int(outs[7])
            if nz > countstep.QV_MAX_EK:
                zl = torch.nonzero(valid & (vals <= 0)).reshape(-1)
            else:
                zl = outs[6][:nz]
            zl = zl.cpu().numpy().astype(np.int64)
            starts_np = np.minimum(packed.rec_start, M)
            zseg = np.searchsorted(starts_np, zl, side="right") - 1
            zb = np.concatenate(
                [np.searchsorted(zseg, np.arange(info[0])), [len(zl)]])
            ek_txt = []
            for j in range(info[0]):
                gi_j = int(packed.rec_gid[j])
                nm = packed.seq_names[gi_j]
                base = int(packed.rec_off0[j]) - int(starts_np[j])
                ek_txt.append("".join(
                    f"EK\t{nm}\t{int(l) + base}\n"
                    for l in zl[zb[j]:zb[j + 1]]))

        if opt.print_each or want_ek:
            # host mirror of totals (a sync per chunk; -p/-E modes only)
            with spans.span("qv.fold"):
                _qv_out_update(packed, info, outs[4].cpu().numpy(),
                               outs[5].cpu().numpy(), h_carry, blocks,
                               opt.min_len, k, opt.print_each, ek_txt=ek_txt,
                               carry_ek=carry_ek)

        # per-chunk progress in the reference shape (qv.c:104-106)
        prog.line(f"processed {nseq} sequences")
    out.write("".join(blocks))
    return state[0].cpu().numpy()


def _qv_lookups(fn, table, chunk, M, min_len, psort, seg=False):
    """Each chunk of `fn` that holds records, in order, with its lookup
    and its meta row on the lookup's device: (packed, vals, valid,
    meta_d, info, ns) (`_qv_chunk_meta`, whose carry mirror needs the
    chunks in order).  One device: the chunk's `lookup_chunk` (with
    `seg`, `qv_lookup_seg`, whose values come in key order and whose
    second output is their segments), its meta uploaded first, as a
    blocking host-to-device copy waits for the work on the stream.  A
    MeshTable: a group's routed lookups, then its chunks' metas by
    copies from pinned memory, which do not."""
    carry = [None]             # host mirror: which seq the carry is

    def meta(packed, dev, non_blocking):
        ns = max(1 << 12,
                 1 << int(max(len(packed.rec_gid) - 1, 1)).bit_length())
        with spans.span("qv.meta"):
            m, info, carry[0] = _qv_chunk_meta(packed, M, ns, carry[0],
                                               min_len)
            m = torch.from_numpy(m)
            if non_blocking and dev.type == "cuda":
                m = m.pin_memory()
            return m.to(dev, non_blocking=non_blocking), info, ns

    if isinstance(table, MeshTable):
        for group, vals, valid in mesh_routed_groups(fn, table, chunk,
                                                     psort=psort):
            metas = [meta(p, v.device, True) for p, v in zip(group, vals)]
            yield from ((p, v, ok) + m
                        for p, v, ok, m in zip(group, vals, valid, metas))
        return
    dev = table.device
    for packed in ChunkSource(fn, chunk, table.k, with_meta="records"):
        if not len(packed.rec_gid):
            continue
        meta_d = meta(packed, dev, False)
        with spans.span("qv.stage"):
            carg = pack_chunk_planes(packed, dev)
        if seg:
            vals, valid = countstep.qv_lookup_seg(
                carg, table.k, table.keys, table.cnt, table.size,
                meta_d[0], meta_d[2])
        else:
            vals, valid = countstep.lookup_chunk(carg, table.k, table.keys,
                                                 table.cnt, table.size,
                                                 psort=psort)
        yield (packed, vals, valid) + meta_d


def _sq_text(name, L, tot, non0, k):
    qv = -1.0
    if tot > 0:
        if non0 > 0:
            if tot > non0:
                qv = math.log(tot / non0) / k
                qv = -_Q * math.log(qv)
            else:
                qv = 99.0
        else:
            qv = 0.0
    return f"SQ\t{name}\t{L}\t{tot}\t{non0}\t{qv:.2f}\n"


def _qv_chunk_meta(packed, M, ns, carry_gi, min_len):
    """Build one chunk's device-fold meta row (ops/countstep._qv_reduce
    contract) plus host bookkeeping.

    Returns (meta i32[2*ns+6], info, new_carry_gi) where info =
    (nseq, g0, has_head, continues, head_end, j_inc) feeds the -p
    bookkeeping (_qv_sq_update) and new_carry_gi is the host mirror of
    the device carry identity."""
    nseq = len(packed.rec_gid)
    gis = packed.rec_gid
    g0, last_gi = int(gis[0]), int(gis[-1])
    # segment bounds: first window lane of each local segment
    starts = np.minimum(packed.rec_start, M)
    # does the last seq continue into the next chunk?
    continues = (int(packed.rec_off0[-1] + packed.rec_take[-1])
                 < int(packed.rec_len[-1]))
    has_head = carry_gi is not None
    if has_head:
        assert carry_gi == g0, "carry must resume the first seg"
    if has_head and continues and nseq == 1:
        head_end, inc_start, j_inc = 0, 0, 0   # middle piece
    else:
        head_end = (int(starts[1]) if nseq > 1 else M) if has_head \
            else 0
        inc_start = int(starts[-1]) if continues else M
        j_inc = nseq - 1 if continues else 0
    head_elig = (packed.seq_lens[carry_gi] >= min_len) \
        if has_head else True
    meta = np.full(2 * ns + 6, M, np.int32)
    meta[:nseq] = starts
    meta[ns + 1:2 * ns + 1] = 0
    meta[ns + 1:ns + 1 + nseq] = packed.rec_len >= min_len
    meta[2 * ns + 1:] = (head_end, inc_start, j_inc, int(head_elig),
                         int(continues))
    if has_head and continues and nseq == 1:
        new_carry = carry_gi                   # carry unchanged
    elif continues:
        new_carry = last_gi
    else:
        new_carry = None
    return meta, (nseq, g0, has_head, continues, head_end, j_inc), \
        new_carry


def _qv_out_update(packed, info, tot_np, non0_np, h_carry, blocks,
                   min_len, k, print_each, ek_txt=None, carry_ek=None):
    """Per-chunk output assembly: per completed sequence, its EK rows
    (-E) followed by its SQ row (-p), in input order (the reference's
    worker emits both inside one per-seq loop, qv.c:62-81);
    chunk-spanning pieces accumulate through h_carry / carry_ek."""
    nseq, g0, has_head, continues, head_end, j_inc = info
    gis = packed.rec_gid
    ek = ek_txt if ek_txt is not None else [""] * nseq
    if has_head and head_end == 0:      # middle piece
        h_carry[0] += int(tot_np[0])
        h_carry[1] += int(non0_np[0])
        if carry_ek is not None:
            carry_ek[0] += ek[0]
        return

    def emit(name, L, tot, non0, ektext):
        if L < min_len:
            return
        t = ektext
        if print_each:
            t += _sq_text(name, L, tot, non0, k)
        if t:
            blocks.append(t)

    if has_head:
        emit(packed.seq_names[g0], packed.seq_lens[g0],
             h_carry[0] + int(tot_np[0]),
             h_carry[1] + int(non0_np[0]),
             ((carry_ek[0] if carry_ek is not None else "") + ek[0]))
        h_carry[:] = [0, 0]
        if carry_ek is not None:
            carry_ek[0] = ""
    for j in range(1 if has_head else 0,
                   nseq - 1 if continues else nseq):
        gi = int(gis[j])
        emit(packed.seq_names[gi], packed.seq_lens[gi],
             int(tot_np[j]), int(non0_np[j]), ek[j])
    if continues:
        h_carry[:] = [int(tot_np[j_inc]), int(non0_np[j_inc])]
        if carry_ek is not None:
            carry_ek[0] += ek[j_inc]


def qv_solve(hist, cnt, kmer, fpr):
    """The empirical QV model (yak_qv_solve).

    hist: 1024-bin histogram of the read table; cnt: 1024-bin occurrence
    histogram of the evaluated sequence's k-mers.  Returns (ret, QStat);
    ret == -1 means the adjusted model was not computable (low coverage)
    and only qv_raw is meaningful.
    """
    hist = np.asarray(hist, np.int64)
    cnt = np.asarray(cnt, np.int64)
    n = YAK_N_COUNTS
    qs = QStat()
    qs.err = float(cnt[0])
    qs.tot = int(cnt.sum())
    qs.adj_cnt = cnt.astype(np.float64).copy()
    if qs.tot > 0 and qs.tot > cnt[0]:
        qs.qv_raw = -_Q * _log(_log(qs.tot / (qs.tot - cnt[0])) / kmer)

    # spectrum peak (first strict max over [2, 1022]) and valley before it
    max_c, max_cnt = -1, 0
    for c in range(2, n - 1):
        if cnt[c] > max_cnt:
            max_cnt, max_c = int(cnt[c]), c
    if max_c < 0:
        qs.fpr_upper = 1.0
        # degenerate input (no counted k-mer occurs twice): the
        # reference reads cnt[-1]/hist[-1] here (qv.c:165 with
        # max_c == -1, OOB) which lands on zeroed allocator memory on
        # this platform -> 0.0/0.0 -> x86 default QNaN, printed
        # "-nan"; reproduce the observable CV line exactly
        qs.cov = float("-nan")
        return -1, qs
    min_c, min_cnt = -1, max_cnt
    for c in range(2, max_c):
        if cnt[c] < min_cnt:
            min_cnt, min_c = int(cnt[c]), c
    qs.cov = cnt[max_c] / hist[max_c] if hist[max_c] else math.inf

    qs.fpr_upper = 1.0
    for c in range(2, max_c):
        denom = qs.cov * hist[c]
        e = cnt[c] / denom if denom else math.inf
        if e < qs.fpr_upper:
            qs.fpr_upper = e
    if fpr > qs.fpr_upper:
        fpr = qs.fpr_upper * 0.5

    qs.fpr_lower = 0.0
    if min_c > 2 and hist[2] > hist[min_c]:
        e = (cnt[2] - cnt[min_c]) / (qs.cov * (hist[2] - hist[min_c]))
        if e > qs.fpr_lower:
            qs.fpr_lower = e
    if fpr < qs.fpr_lower:
        fpr = qs.fpr_lower
    if qs.fpr_lower >= qs.fpr_upper:
        print("Warning: the FPR upper bound is smaller than the lower bound. "
              "Trust the lower bound.", file=sys.stderr)

    if max_c <= 4:
        return -1, qs
    n_ext = min(max_c - min_c + 1, 8)
    if n_ext < 3:
        return -1, qs

    # sampling-error adjustment in [min_c, max_c); cov == 0 or fpr == 1
    # must propagate nan/inf exactly as the C arithmetic does
    with np.errstate(divide="ignore", invalid="ignore"):
        for c in range(max_c - 1, min_c - 1, -1):
            err = (hist[c] - cnt[c] / qs.cov) / (1.0 - fpr)
            qs.adj_cnt[c] = max(cnt[c] - err * qs.cov * fpr, 0.0)

    # degree-2 polynomial fit of adjacent-count ratios (normal equations)
    x = np.arange(min_c, min_c + n_ext, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        y = (qs.adj_cnt[min_c + 1:min_c + n_ext + 1]
             / qs.adj_cnt[min_c:min_c + n_ext])
    powers = x[None, :] ** np.arange(5)[:, None]  # x^0..x^4 per point
    A = np.empty((3, 3))
    B = np.empty(3)
    with np.errstate(invalid="ignore"):
        for i in range(3):
            for j in range(i + 1):
                A[i, j] = A[j, i] = powers[i + j].sum()
            B[i] = (powers[i] * y).sum()
        coef = _solve_full_pivot(A, B)

        # extrapolate below min_c
        for c in range(min_c - 1, -1, -1):
            r = coef[0] + coef[1] * c + coef[2] * c * c
            if r < 1.01:  # NaN stays NaN, like the C comparison
                r = 1.01
            qs.adj_cnt[c] = qs.adj_cnt[c + 1] / r

    adj_sum = float(qs.adj_cnt.sum())
    if adj_sum <= qs.tot:
        qs.err = qs.tot - adj_sum
        qs.qv = -_Q * _log(_log(qs.tot / adj_sum) / kmer)
    else:
        print("WARNING: failed to estimate the calibrated QV", file=sys.stderr)
        qs.err = 0.0
        qs.qv = qs.qv_raw
    return 0, qs


def _cf(v, spec=".3f"):
    """printf-compatible float text (C prints NaN with its sign bit)."""
    if math.isnan(v):
        return "-nan" if math.copysign(1.0, v) < 0 else "nan"
    if math.isinf(v):
        return "-inf" if v < 0 else "inf"
    return f"{v:{spec}}"


QV_HEADER = (
    "CC\tCT  kmer_occurrence    short_read_kmer_count  raw_input_kmer_count  "
    "adjusted_input_kmer_count\n"
    "CC\tFR  fpr_lower_bound    fpr_upper_bound\n"
    "CC\tER  total_input_kmers  adjusted_error_kmers\n"
    "CC\tCV  coverage\n"
    "CC\tQV  raw_quality_value  adjusted_quality_value\n"
    "CC\n")


def main_qv(opt, table, seq_fn, out=None):
    """The `qv` command body (main_qv, main.c:163-215)."""
    out = out or sys.stdout
    with spans.span("qv.hist"):
        hist = table.hist()
    out.write(QV_HEADER)
    cnt = run_qv(opt, seq_fn, table, out=out)
    with spans.span("qv.solve"):
        _, qs = qv_solve(hist, cnt, table.k, opt.fpr)
        for i in range(YAK_N_COUNTS - 1, -1, -1):
            out.write(f"CT\t{i}\t{hist[i]}\t{cnt[i]}\t"
                      f"{_cf(qs.adj_cnt[i])}\n")
        out.write(f"FR\t{_cf(qs.fpr_lower, '.3g')}\t"
                  f"{_cf(qs.fpr_upper, '.3g')}\n")
        out.write(f"ER\t{qs.tot}\t{_cf(qs.err)}\n")
        out.write(f"CV\t{_cf(qs.cov)}\n")
        out.write(f"QV\t{_cf(qs.qv_raw)}\t{_cf(qs.qv)}\n")
    return qs
