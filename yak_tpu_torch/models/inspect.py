"""Spectrum inspection (inspect.c): the one-table cumulative histogram
and the two-table k-mer QV / sensitivity cross-tabulation.

Port of `yak_tpu/models/inspect.py`.  One table: the `HS` rows from a
streamed read of the file, on the host.  Two tables: the second table
lives on the device; the first is streamed (`io/yakfmt.open_yak_stream`)
in batches of `batch_keys` full hashes, each looked up by
`KmerTable.lookup_hashes` (the query sort and the JOIN kernel), and the
1024 x 1024 cross-tabulation of (count in the first, count in the
second or 0) gathers on the device by one bincount a batch.

Two-table note (SURVEY §2.1), mirrored from the JAX package: the C
reference probes the second table with the raw on-disk key
(inspect.c:57), which almost always misses; both packages rebuild the
full hash, (key >> counter_bits) << pre | shard, before the lookup.
"""

import sys

import numpy as np
import torch

from yak_tpu_torch import YAK_N_COUNTS
from yak_tpu_torch.io.yakfmt import open_yak_stream
from yak_tpu_torch.models.qv import _cf, qv_solve
from yak_tpu_torch.ops.keys import u64_to_torch
from yak_tpu_torch.table import KmerTable

_BATCH = 1 << 22


def main_inspect(fn1, fn2=None, max_cnt=20, fpr=0.00004, out=None,
                 batch_keys=_BATCH, device="cuda"):
    """The `inspect` command body; the second table, when given, is
    loaded on `device`."""
    out = out or sys.stdout
    k1, _pre1, batches = open_yak_stream(fn1, batch_keys)

    if fn2 is None:
        tot = np.zeros(YAK_N_COUNTS, np.int64)
        for _h, c in batches:
            tot += np.bincount(c, minlength=YAK_N_COUNTS)
        acc_tot = 0
        for i in range(YAK_N_COUNTS - 1, -1, -1):
            acc_tot += int(tot[i])
            if acc_tot == 0:
                continue
            out.write(f"HS\t{i}\t0\t{tot[i]}\t{acc_tot}\n")
        return

    ch = KmerTable.restore(fn2, device)
    hist = ch.hist()
    dev = ch.device
    tot = np.zeros(YAK_N_COUNTS, np.int64)
    cross = torch.zeros(YAK_N_COUNTS * YAK_N_COUNTS, dtype=torch.int64,
                        device=dev)
    for h_np, c0_np in batches:
        tot += np.bincount(c0_np, minlength=YAK_N_COUNTS)
        h = u64_to_torch(h_np, dev)
        c1 = ch.lookup_hashes(h, torch.ones(h.shape, dtype=torch.bool,
                                            device=dev)).clamp(min=0)
        c0 = torch.from_numpy(c0_np).to(dev)
        cross += torch.bincount(c0.to(torch.int64) * YAK_N_COUNTS + c1,
                                minlength=YAK_N_COUNTS * YAK_N_COUNTS)
    cnt = cross.reshape(YAK_N_COUNTS, YAK_N_COUNTS).cpu().numpy()

    # SN rows: cumulative sensitivity of in2 at occurrence thresholds
    acc = cnt.copy()
    for j in range(YAK_N_COUNTS - 2, 0, -1):
        acc[:, j] += acc[:, j + 1]
    acc_cnt = np.zeros(YAK_N_COUNTS, np.int64)
    acc_tot = 0
    for i in range(YAK_N_COUNTS - 1, -1, -1):
        acc_tot += int(tot[i])
        if acc_tot == 0 or tot[i] == 0:
            continue
        row = [f"SN\t{i}\t{tot[i]}\t{hist[i]}"]
        for j in range(1, max_cnt + 1):
            acc_cnt[j] += acc[i, j]
            row.append(f"\t{acc_cnt[j] / acc_tot:.4f}")
        out.write("".join(row) + "\n")

    # QV rows per min-occurrence threshold, reusing the QV model
    acc2 = cnt.copy()
    for i in range(YAK_N_COUNTS - 2, -1, -1):
        acc2[i] += acc2[i + 1]
    for i in range(max_cnt, 0, -1):
        if tot[i] == 0:
            continue
        _, qs = qv_solve(hist, acc2[i], k1, fpr)
        out.write(f"QV\t{i}\t{qs.tot}\t{acc2[i, 0]}\t{_cf(qs.qv_raw)}\t"
                  f"{_cf(qs.qv)}\n")
