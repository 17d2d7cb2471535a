"""Plain `yak qv -p` output, the reference of the qv cells.

Written from yak's qv.c (yak_qv's per-sequence loop, yak_qv_solve and
main_qv's printing) with the 6gjdn.c solver: each whole sequence at
once, its windows' counts looked up in the reference table
(`kmers.lookup`), the float model in plain Python floats.
"""

import math

import torch

from kbench.reference import kmers

Q = 4.3429448190325175  # 10 / ln 10
# the NaN an invalid operation gives on x86 (sign bit set, printed
# "-nan"), which yak's printed text carries
NAN = math.copysign(math.nan, -1.0)

HEADER = (
    "CC\tCT  kmer_occurrence    short_read_kmer_count  raw_input_kmer_count  "
    "adjusted_input_kmer_count\n"
    "CC\tFR  fpr_lower_bound    fpr_upper_bound\n"
    "CC\tER  total_input_kmers  adjusted_error_kmers\n"
    "CC\tCV  coverage\n"
    "CC\tQV  raw_quality_value  adjusted_quality_value\n"
    "CC\n")


def _log(x):
    """C's log: -inf at 0, NaN below (a NaN passes through)."""
    if x != x:
        return x
    if x < 0:
        return NAN
    return -math.inf if x == 0 else math.log(x)


def _div(a, b):
    """C's double division: x / 0 is +-inf, 0 / 0 NaN (a NaN passes
    through)."""
    if a != a:
        return a
    if b == 0:
        if a == 0:
            return NAN
        return math.copysign(math.inf, a) * math.copysign(1.0, b)
    return a / b


def _fmt(v, spec=".3f"):
    """printf's text of a double (a NaN prints with its sign)."""
    if math.isnan(v):
        return "-nan" if math.copysign(1.0, v) < 0 else "nan"
    if math.isinf(v):
        return "-inf" if v < 0 else "inf"
    return format(v, spec)


def sq_line(name, length, tot, non0, k):
    """The SQ row of one sequence (qv.c's -p line)."""
    qv = -1.0
    if tot > 0:
        if non0 == 0:
            qv = 0.0
        elif tot > non0:
            qv = -Q * math.log(math.log(tot / non0) / k)
        else:
            qv = 99.0
    return f"SQ\t{name}\t{length}\t{tot}\t{non0}\t{qv:.2f}\n"


def gjdn(a, b):
    """Gauss-Jordan with full pivoting on a 3 x 3 system (6gjdn.c),
    lists of floats changed in place; b ends as the solution.  On a
    singular pivot it stops, leaving b as it is (qv.c ignores the
    return value)."""
    n = len(b)
    col = []
    for k in range(n):
        d, pr, pc = 0.0, k, k
        for i in range(k, n):
            for j in range(k, n):
                t = abs(a[i][j])
                if t > d:
                    d, pr, pc = t, i, j
        if d + 1.0 == 1.0:
            return b
        col.append(pc)
        if pc != k:
            for i in range(n):
                a[i][k], a[i][pc] = a[i][pc], a[i][k]
        if pr != k:
            for j in range(k, n):
                a[k][j], a[pr][j] = a[pr][j], a[k][j]
            b[k], b[pr] = b[pr], b[k]
        d = a[k][k]
        for j in range(k + 1, n):
            a[k][j] = _div(a[k][j], d)
        b[k] = _div(b[k], d)
        for j in range(k + 1, n):
            for i in range(n):
                if i != k:
                    a[i][j] -= a[i][k] * a[k][j]
        for i in range(n):
            if i != k:
                b[i] -= a[i][k] * b[k]
    for k in range(n - 1, -1, -1):
        if col[k] != k:
            b[k], b[col[k]] = b[col[k]], b[k]
    return b


def solve(hist, cnt, k, fpr):
    """yak_qv_solve: (qv_raw, qv, cov, err, fpr_lower, fpr_upper, adj)
    from the read table's histogram and the sequence's occurrence
    histogram (lists of 1024 ints)."""
    n = len(cnt)
    tot = sum(cnt)
    err = float(cnt[0])
    adj = [float(c) for c in cnt]
    qv_raw = qv = -1.0
    if tot > 0 and tot > cnt[0]:
        qv_raw = -Q * _log(_div(_log(tot / (tot - cnt[0])), k))
    max_c, max_cnt = -1, 0
    for c in range(2, n - 1):
        if cnt[c] > max_cnt:
            max_c, max_cnt = c, cnt[c]
    if max_c < 0:      # no k-mer twice: qv.c reads past the histogram
        return qv_raw, qv, NAN, err, 0.0, 1.0, adj
    min_c, min_cnt = -1, max_cnt
    for c in range(2, max_c):
        if cnt[c] < min_cnt:
            min_c, min_cnt = c, cnt[c]
    cov = _div(float(cnt[max_c]), float(hist[max_c]))
    fpr_upper = 1.0
    for c in range(2, max_c):
        e = _div(float(cnt[c]), cov * hist[c])
        if e < fpr_upper:
            fpr_upper = e
    if fpr > fpr_upper:
        fpr = fpr_upper * 0.5
    fpr_lower = 0.0
    if min_c > 2 and hist[2] > hist[min_c]:
        e = _div(float(cnt[2] - cnt[min_c]), cov * (hist[2] - hist[min_c]))
        if e > fpr_lower:
            fpr_lower = e
    if fpr < fpr_lower:
        fpr = fpr_lower
    if max_c <= 4:
        return qv_raw, qv, cov, err, fpr_lower, fpr_upper, adj
    n_ext = min(max_c - min_c + 1, 8)
    if n_ext < 3:
        return qv_raw, qv, cov, err, fpr_lower, fpr_upper, adj
    for c in range(max_c - 1, min_c - 1, -1):
        e = _div(hist[c] - _div(float(cnt[c]), cov), 1.0 - fpr)
        adj[c] = max(cnt[c] - e * cov * fpr, 0.0)
    xs = [float(min_c + i) for i in range(n_ext)]
    ys = [_div(adj[min_c + i + 1], adj[min_c + i]) for i in range(n_ext)]
    a = [[0.0] * 3 for _ in range(3)]
    b = [0.0] * 3
    for i in range(3):
        for j in range(i + 1):
            s = 0.0
            for x in xs:
                s += x ** (i + j)
            a[i][j] = a[j][i] = s
        s = 0.0
        for x, y in zip(xs, ys):
            s += x ** i * y
        b[i] = s
    coef = gjdn(a, b)
    for c in range(min_c - 1, -1, -1):
        r = coef[0] + coef[1] * c + coef[2] * c * c
        if r < 1.01:
            r = 1.01
        adj[c] = _div(adj[c + 1], r)
    adj_sum = sum(adj)
    if adj_sum <= tot:
        err = tot - adj_sum
        qv = -Q * _log(_div(_log(tot / adj_sum), k))
    else:
        err, qv = 0.0, qv_raw
    return qv_raw, qv, cov, err, fpr_lower, fpr_upper, adj


def qv_text(tkeys, tcounts, seqs, k, min_len, min_frac, fpr,
            lookup=kmers.lookup):
    """The whole stdout of `yak qv -p -l min_len` for sequences `seqs`
    (name, uint8 codes [L]), N-free, against the table (tkeys, tcounts)
    (`kmers.two_pass_table`), each window's count taken by `lookup`."""
    table_hist = [int(v) for v in kmers.hist(tcounts).tolist()]
    cnt = torch.zeros(kmers.N_COUNTS, dtype=torch.int64,
                      device=tkeys.device)
    rows = []
    for name, codes in seqs:
        length = codes.numel()
        if length < min_len:
            continue
        c = lookup(tkeys, tcounts,
                         kmers.window_hashes(codes[None], k)[0])
        tot, non0 = c.numel(), int((c > 0).sum())
        rows.append(sq_line(name, length, tot, non0, k))
        if non0 >= tot * min_frac:
            cnt += kmers.hist(c)
    cnt = [int(v) for v in cnt.tolist()]
    qv_raw, qv, cov, err, lo, hi, adj = solve(table_hist, cnt, k, fpr)
    out = [HEADER] + rows
    for i in range(kmers.N_COUNTS - 1, -1, -1):
        out.append(f"CT\t{i}\t{table_hist[i]}\t{cnt[i]}\t{_fmt(adj[i])}\n")
    out.append(f"FR\t{_fmt(lo, '.3g')}\t{_fmt(hi, '.3g')}\n")
    out.append(f"ER\t{sum(cnt)}\t{_fmt(err)}\n")
    out.append(f"CV\t{_fmt(cov)}\n")
    out.append(f"QV\t{_fmt(qv_raw)}\t{_fmt(qv)}\n")
    return "".join(out)
