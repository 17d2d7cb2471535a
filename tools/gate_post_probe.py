"""Where the -b37 count's device memory peaks, on one CUDA card.

    python3 tools/gate_post_probe.py [--root DIR] [--seed N]
        [--scan kernel|scatter] [--out FILE]

runs one job of the benchmark's `sr-k31.count-b37` cell (kbench/: 4 M
reads given twice through named pipes, `count -b37`) from the checkout
at --root (default: this one), after the cell's warm-up job, under
`torch.cuda.memory`'s allocation history (Python stacks): the job's
peak of allocated bytes (max_memory_allocated beside it) and the blocks
live at that peak, summed by the innermost frame of the program
(`yak_tpu_torch/...:line function`), largest first, and the program's
frames of the allocation that reached it.  With --scan scatter (a
checkout with ops/scan.py) the gate post's run heads are found by
`sorttable.last_set_lane_scatter`, library calls alone, in place of the
scan kernel.

Prints the card's name and power limit and the table, and last one JSON
object (also written to --out).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch

CELL = "sr-k31.count-b37"


def card_line():
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return q.stdout.strip() or torch.cuda.get_device_name(0)


def make_job(root, seed, tmp):
    from kbench import harness

    cell = harness.find_cell(root, CELL)
    job = cell.job.make(cell.cfg, cell.mix, seed, "cuda:0", tmp)
    job.warm()
    torch.cuda.synchronize()
    return job


def _site(frames):
    """The innermost frame of the program, else the innermost of all."""
    for f in frames:
        if "yak_tpu_torch" in f["filename"]:
            path = f["filename"][f["filename"].rindex("yak_tpu_torch"):]
            return f"{path}:{f['line']} {f['name']}"
    f = frames[0] if frames else {"filename": "?", "line": 0, "name": "?"}
    return f"{os.path.basename(f['filename'])}:{f['line']} {f['name']}"


def memory_peak(job):
    """The job's peak of allocated bytes and the blocks live at it."""
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                             stacks="python")
    t0 = time.perf_counter()
    out = job.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    peak_alloc = torch.cuda.max_memory_allocated()
    del out
    events = [e for tr in snap["device_traces"] for e in tr]
    free = ("free_completed"
            if any(e["action"] == "free_completed" for e in events)
            else "free_requested")
    live, cur, peak, at_peak, peak_ev = {}, base, base, {}, None
    for e in events:
        if e["action"] == "alloc":
            live[e["addr"]] = (e["size"], e.get("frames", []))
            cur += e["size"]
            if cur > peak:
                peak, at_peak, peak_ev = cur, dict(live), e
        elif e["action"] == free:
            size = live.pop(e["addr"], (e["size"], None))[0]
            cur -= size
    sites = defaultdict(lambda: [0, 0])
    for size, frames in at_peak.values():
        s = sites[_site(frames)]
        s[0] += size
        s[1] += 1
    rows = sorted(sites.items(), key=lambda kv: -kv[1][0])
    stack = [_site([f]) for f in (peak_ev or {}).get("frames", [])
             if "yak_tpu_torch" in f["filename"]]
    return {"job_s": secs, "events": len(events),
            "max_memory_allocated": peak_alloc, "replayed_peak": peak,
            "before_job": base,
            "live_at_peak": [[k, v[0], v[1]] for k, v in rows],
            "peak_alloc_stack": stack}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parent.parent))
    ap.add_argument("--seed", type=int, default=2_654_435_761)
    ap.add_argument("--scan", choices=("kernel", "scatter"),
                    default="kernel")
    ap.add_argument("--out")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    if args.scan == "scatter":
        from yak_tpu_torch.ops import scan
        from yak_tpu_torch.ops.sorttable import last_set_lane_scatter

        scan.last_set_lane = last_set_lane_scatter
    print(f"card: {card_line()}; program: {root}; scan: {args.scan}",
          flush=True)
    res = {"root": str(root), "seed": args.seed, "scan": args.scan,
           "card": card_line()}
    with tempfile.TemporaryDirectory(prefix="gate-post-probe-") as tmp:
        job = make_job(root, args.seed, tmp)
        m = res["memory"] = memory_peak(job)
        del job
    gib = 1 << 30
    print(f"memory: max_memory_allocated "
          f"{m['max_memory_allocated'] / gib:.4f} GiB, replayed peak "
          f"{m['replayed_peak'] / gib:.4f} GiB ({m['before_job'] / gib:.4f} "
          f"before the job; {m['events']} events, job {m['job_s']:.2f} s); "
          f"live at the peak:")
    for site, size, count in m["live_at_peak"][:25]:
        print(f"  {size / gib:9.4f} GiB  {count:4d}  {site}")
    print("  the allocation that reached it: "
          + " <- ".join(m["peak_alloc_stack"][:8]), flush=True)
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
