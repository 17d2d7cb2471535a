"""Sex-chromosome k-mer partitioning (sexchr.c) and the groupxy
post-processing (groupxy.pl).

Port of `yak_tpu/models/sexchr.py`, its one-device path.  The chrY,
chrX and PAR tables load as presence bits 1, 2 and 4 (the SEXCHR1/2/3
load modes, htab.c:462-470) into one table by restore-into; hap1 then
hap2 are scanned, and each contig gets its number of k-mers, of k-mers
with any flag, and of k-mers with flag 1 or 2 alone (sc_worker,
sexchr.c:61-71): per chunk, the lookups and the four segment sums run
on the table's device (`models/scan.scan_seg_sums` with
`countstep.sexchr_reduce`), or, for a MeshTable, through the routed
lookups with each chunk's sums on its own device
(`scan.scan_seg_sums_mesh`, yak_tpu/models/sexchr.py:49-60).
`groupxy` runs on the host.
"""

import sys
from dataclasses import dataclass

from yak_tpu_torch import (YAK_LOAD_SEXCHR1, YAK_LOAD_SEXCHR2,
                           YAK_LOAD_SEXCHR3)
from yak_tpu_torch.models.scan import scan_seg_sums, scan_seg_sums_mesh
from yak_tpu_torch.parallel.mesh import MeshTable
from yak_tpu_torch.table import KmerTable


@dataclass
class SexchrOpts:
    n_threads: int = 8
    chunk_size: int = 1_000_000_000


def load_sexchr_tables(chry_fn, chrx_fn, par_fn, device):
    ch = KmerTable.restore(chry_fn, device, mode=YAK_LOAD_SEXCHR1)
    ch = KmerTable.restore(chrx_fn, device, mode=YAK_LOAD_SEXCHR2, into=ch)
    return KmerTable.restore(par_fn, device, mode=YAK_LOAD_SEXCHR3, into=ch)


SEXCHR_HEADER = (
    "C\tS  seqName  originalHap  0  #k-mer  #sexchr  #sex1-specifc  "
    "#sex2-specific\n"
    "C\n")


def main_sexchr(opt, ch, hap_fns, out=None):
    """The `sexchr` command body: one S row a contig of each haplotype
    file, in order."""
    out = out or sys.stdout
    out.write(SEXCHR_HEADER)
    chunk = max(1 << 14, min(int(opt.chunk_size), 1 << 23))
    chunk = -(-chunk // 1024) * 1024
    seg_sums = (scan_seg_sums_mesh if isinstance(ch, MeshTable)
                else scan_seg_sums)
    for hap, fn in enumerate(hap_fns, start=1):
        for name, _L, (n_k, n_sexchr, n_sex1, n_sex2) in seg_sums(
                fn, ch, chunk):
            out.write(f"S\t{name}\t{hap}\t0\t{n_k}\t{n_sexchr}\t{n_sex1}\t"
                      f"{n_sex2}\n")


def groupxy(lines, s_thres=0.7, c_thres=0.3, r_thres=0.9):
    """Post-process sexchr output rows into final X/Y partitions
    (groupxy.pl): per-contig assignment with thresholds, then a global
    resolution of which haplotype is X vs Y, rewriting column 4."""
    rows = []
    for line in lines:
        t = line.rstrip("\n").split("\t")
        if t[0] != "S":
            continue
        rows.append(t)
    c = [0, 0, 0, 0]
    for t in rows:
        n_k, n_sexchr, n_sex1, n_sex2 = (int(t[4]), int(t[5]), int(t[6]),
                                         int(t[7]))
        if n_sexchr < n_k * s_thres:
            continue
        if n_sex1 + n_sex2 < n_sexchr * c_thres:
            continue
        tot = n_sex1 + n_sex2
        t[3] = ("3" if n_sex1 > tot * r_thres
                else "4" if n_sex2 > tot * r_thres else "0")
        if t[3] == "0":
            continue
        hap = int(t[2]) - 1
        c[hap << 1 | 0] += n_sex1
        c[hap << 1 | 1] += n_sex2
    max_chr = 0 if c[0] + c[2] > c[1] + c[3] else 1
    type_ = (0 if c[0 << 1 | max_chr] > c[1 << 1 | max_chr] else 1) ^ max_chr
    for t in rows:
        v = int(t[3])
        if v >= 3:
            t[3] = str(v - 2)
        else:
            t[3] = str(int(t[2]) if type_ == 0 else 3 - int(t[2]))
    return ["\t".join(t) for t in rows]
