"""The control of `correct`: the reference put in the program's place
with one of the configuration's guarantees broken, judged by the same
comparisons as the program.  It has to come out not correct.

  count cells: the -b protocol's first pass alone (no second pass, so
    a key's count misses its first sighting, which only set the Bloom
    bits): the tempting halving of the job.  The counts are no longer
    exact.
  qv cells: each window looked up by a fingerprint of its hash, the
    low bits that give a one in a thousand false match a query (a
    fingerprint table in place of the full keys, as a quotient or
    cuckoo filter keeps), so an absent k-mer may read another's count.
    The lookups are no longer exact.

  python3 kbench/control.py --workload <name> --seeds 1 2 3

prints each seed's numbers beside their limits, at the cell's own size
(on the card where there is one).  The benchmark's own runs never run
it.
"""

import argparse
import math
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from kbench import compare, harness, inputs  # noqa: E402
from kbench.reference import kmers  # noqa: E402
from kbench.reference import qv as ref_qv  # noqa: E402

FALSE_MATCH = 1e-3      # the fingerprint table's false matches a query


def pass1_table(keys, counts):
    """The -b protocol stopped after its first pass, with the shrink: a
    key enters at its second sighting, so its count is one short."""
    c = counts - 1
    keep = c >= 2
    return keys[keep], c[keep].clamp(max=kmers.MAX_COUNT)


def fingerprint_lookup(tkeys, tcounts, queries):
    """`kmers.lookup` through the low b bits of the keys, b the fewest
    that keep a query's false matches to FALSE_MATCH: a query takes the
    count of a table key that shares them, 0 where none does."""
    bits = max(1, math.ceil(math.log2(max(tkeys.numel(), 1)
                                      / FALSE_MATCH)))
    low = (1 << bits) - 1
    fp, order = torch.sort(tkeys & low)
    q = queries & low
    pos = torch.searchsorted(fp, q).clamp(max=max(fp.numel() - 1, 0))
    return torch.where(fp[pos] == q, tcounts[order[pos]], 0)


def control_numbers(cfg, mix, seed, device):
    """The control's numbers for one seed: (reference's, control's)
    comparisons, each a dict of numbers."""
    reads, seqs = inputs.make(cfg, seed, device)
    keys, counts = kmers.count(inputs.read_blocks(reads), cfg["k"])
    del reads
    ref_keys, ref_counts = kmers.two_pass_table(keys, counts)
    if mix["job"] == "count":
        ck, cc = pass1_table(keys, counts)
        return compare.judge_table(ck, cc, kmers.hist(cc).cpu(), ref_keys,
                                   ref_counts)
    del keys, counts
    args = (seqs, cfg["k"], mix["min_len"], mix["min_frac"], mix["fpr"])
    text = ref_qv.qv_text(ref_keys, ref_counts, *args)
    ctl = ref_qv.qv_text(ref_keys, ref_counts, *args,
                         lookup=fingerprint_lookup)
    return {"lines_wrong": compare.lines_wrong(ctl, text)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    cell = harness.find_cell(root, args.workload)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        t0 = time.perf_counter()
        nums = control_numbers(cell.cfg, cell.mix, seed, device)
        fails = {k: v for k, v in nums.items() if v > harness.LIMIT}
        print(f"control {args.workload} seed {seed} on {device}: "
              + " ".join(f"{k} {v} limit {harness.LIMIT}"
                         for k, v in nums.items())
              + f" -> {'not correct' if fails else 'CORRECT'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
