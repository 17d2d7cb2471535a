"""The `qv` job: `yak qv -p -K<chunk> -l<min_len> sr.yak asm.fa` on the
program, against the read table that set-up counts (`yak count -b`
over the reads given once as both inputs, one named pipe), the
assembly a FASTA file; the job ends when its text and QV lines are in
an in-memory buffer.  The work is the k-mer windows of the contigs of
at least min_len bases.

Checked against `reference.qv` over the reference's own table: the
table set-up built, key for key, and every job's text, line for line.
"""

import io
import os
import time

from kbench import compare, feed, gen, inputs
from kbench.reference import kmers
from kbench.reference import qv as ref_qv
from yak_tpu_torch.models.count import CountOpts, count
from yak_tpu_torch.models.qv import QvOpts, main_qv

WARM_BP = 1 << 18        # one chunk of one contig for the warm-up job


class QvJob:
    def __init__(self, cfg, mix, seed, device, tmp):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.k = cfg["k"]
        t0 = time.perf_counter()
        reads, seqs = inputs.make(cfg, seed, device)
        fastq = gen.fastq(reads)
        del reads
        t1 = time.perf_counter()
        tab = cfg["table"]
        pipe = feed.make_pipe(os.path.join(tmp, "reads.fq"))
        with feed.Feed(pipe, fastq):
            self.table = count([pipe, pipe], CountOpts(
                k=self.k, pre=cfg["pre"], bf_shift=tab["bf_shift"],
                bf_n_hash=tab["bf_n_hash"], chunk_size=tab["chunk_size"],
                device=device))
        del fastq
        t2 = time.perf_counter()
        names = [n for n, _ in seqs]
        self.asm = os.path.join(tmp, "asm.fa")
        with open(self.asm, "wb") as f:
            f.write(gen.fasta([c for _, c in seqs], names))
        self.warm_asm = os.path.join(tmp, "warm.fa")
        with open(self.warm_asm, "wb") as f:
            f.write(gen.fasta([seqs[0][1][:WARM_BP]], names[:1]))
        self.work = sum(c.numel() - self.k + 1 for _, c in seqs
                        if c.numel() >= mix["min_len"])
        del seqs
        self.opts = QvOpts(print_each=mix["print_each"],
                           min_len=mix["min_len"],
                           chunk_size=mix["chunk_size"],
                           min_frac=mix["min_frac"], fpr=mix["fpr"])
        self.texts = []
        self.setup_parts = {"reads as FASTQ": t1 - t0, "table": t2 - t1,
                            "assembly": time.perf_counter() - t2}

    def _qv(self, path):
        out = io.StringIO()
        main_qv(self.opts, self.table, path, out=out)
        return out.getvalue()

    def warm(self):
        self._qv(self.warm_asm)

    def run(self):
        return self._qv(self.asm)

    def keep(self, text, last):
        self.texts.append(text)

    def reference(self):
        """The reference's table, from the reads made again from the
        seed, and its qv text over the contigs made again."""
        reads, seqs = inputs.make(self.cfg, self.seed, self.device)
        keys, counts = kmers.two_pass_table(
            *kmers.count(inputs.read_blocks(reads), self.k))
        del reads
        m = self.mix
        text = ref_qv.qv_text(keys, counts, seqs, self.k, m["min_len"],
                              m["min_frac"], m["fpr"])
        return keys, counts, text

    def check(self):
        t = self.table
        n = t.tot
        tkeys, tcounts, thist = t.keys[:n].clone(), t.cnt[:n].clone(), \
            t.hist()
        self.table = t = None
        ref_keys, ref_counts, ref_text = self.reference()
        nums = compare.judge_table(tkeys, tcounts, thist, ref_keys,
                                   ref_counts)
        wrong = [compare.lines_wrong(x, ref_text) for x in self.texts]
        nums["lines_wrong"] = max(wrong, default=0)
        nums["jobs_wrong"] = sum(w > 0 for w in wrong)
        return nums, nums["jobs_wrong"]


make = QvJob
