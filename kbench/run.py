"""Run one cell of the benchmark once and print its result line.

  python3 kbench/run.py --workload <name> --seed <n> --seconds <s>
      --trace <0|1>

from the root of a checkout, on a machine with the chips the cell asks
for.  With --trace 0 the result holds the cell's end-to-end metrics,
with --trace 1 its per-layer metrics, read from a `torch.profiler`
trace of the window and from spans that the benchmark records around
the program's calls.  The last lines of standard error, and the
result's last key "checks", give each number compared with the plain
reference beside its limit.

Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), without the program beside the benchmark, or
when the process has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "yak_tpu"}

# the program builds its kernels and reader into build/yak_tpu_torch/
# of this checkout (ops/cuda_build.py), so only a checkout's first run
# builds; it keeps no other cache
sys.path.insert(0, str(ROOT))


def forbidden_modules():
    """JAX or the JAX package among the loaded modules, compared by the
    whole top-level name (`yak_tpu_torch` is not `yak_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from kbench import harness

    cell = harness.find_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("kbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"kbench: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              args.trace, "cuda:0", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"kbench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    if args.trace:
        harness.log(f"power limit {power_limit()} (the roofline shares are "
                    f"of the H100 SXM's 3.35 TB/s)")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def power_limit():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return out.stdout.strip() or f"unknown ({out.stderr.strip()})"


if __name__ == "__main__":
    sys.exit(main())
