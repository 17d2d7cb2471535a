"""The `count` job: `yak count [-b N] -o sr.yak <(reads) <(reads)` on
the program, the reads served through two named pipes, so that with -b
the literal two-pass protocol runs; the job ends when the table is
final on the device.  The work is the reads' k-mer windows, counted
once however many passes the options make.

Checked against `reference.kmers`: every job's table by its digest,
the last job's whole, key for key, with its histogram."""

import contextlib
import os
import time

from kbench import compare, feed, gen, inputs
from kbench.reference import kmers
from yak_tpu_torch.models.count import CountOpts, count

WARM_READS = 1 << 16     # one chunk of reads for the warm-up job


class CountJob:
    def __init__(self, cfg, mix, seed, device, tmp):
        self.cfg, self.seed, self.device = cfg, seed, device
        self.k = cfg["k"]
        t = time.perf_counter()
        reads, _ = inputs.make(cfg, seed, device)
        self.fastq = gen.fastq(reads)
        self.setup_parts = {"reads as FASTQ": time.perf_counter() - t}
        self.warm_fastq = self.fastq[:WARM_READS * (len(self.fastq)
                                                    // reads.shape[0])]
        self.work = reads.shape[0] * (cfg["read_len"] - self.k + 1)
        del reads
        self.pipes = [feed.make_pipe(os.path.join(tmp, f"reads_{s}.fq"))
                      for s in "ab"][:mix["inputs"]]
        self.opts = CountOpts(k=self.k, pre=cfg["pre"],
                              bf_shift=mix.get("bf_shift", 0),
                              bf_n_hash=mix.get("bf_n_hash", 4),
                              chunk_size=mix.get("chunk_size", 10_000_000),
                              device=device)
        self.digests = []
        self.last = None

    def _count(self, data):
        with contextlib.ExitStack() as feeds:
            for p in self.pipes:
                feeds.enter_context(feed.Feed(p, data))
            return count(self.pipes, self.opts)

    def warm(self):
        self._count(self.warm_fastq)

    def run(self):
        return self._count(self.fastq)

    def keep(self, table, last):
        """Record a job's answer: its digest; the last job's table and
        histogram whole (the others are freed before the next job)."""
        n = table.tot
        keys, counts = table.keys[:n], table.cnt[:n]
        self.digests.append(compare.table_digest(keys, counts))
        if last:
            self.last = (keys.clone(), counts.clone(), table.hist())

    def reference(self):
        """(keys, counts) of the reference's table, from the reads made
        again from the seed."""
        reads, _ = inputs.make(self.cfg, self.seed, self.device)
        keys, counts = kmers.count(inputs.read_blocks(reads), self.k)
        del reads
        if self.opts.bf_shift > 0:
            return kmers.two_pass_table(keys, counts)
        return keys, counts.clamp(max=kmers.MAX_COUNT)

    def check(self):
        keys, counts, prog_hist = self.last
        self.last = None
        ref_keys, ref_counts = self.reference()
        nums = compare.judge_table(keys, counts, prog_hist, ref_keys,
                                   ref_counts)
        ref_digest = compare.table_digest(ref_keys, ref_counts)
        nums["jobs_wrong"] = sum(d != ref_digest for d in self.digests)
        return nums, nums["jobs_wrong"]


make = CountJob
