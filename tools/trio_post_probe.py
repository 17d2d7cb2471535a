"""Times the trio paths' plain-torch posts (yak_tpu_torch/ops/countstep.py)
and two PyTorch scans under them, on one CUDA card.

The run starts of the trio typing are a running maximum of the run
heads' lanes (`jax.lax.cummax` in the JAX package), and triobin's eight
segment sums come from a prefix sum of eight planes.  This script times,
device only, on seeded inputs of the trio shape (8,388,578 lanes, type
runs of 25 lanes on average):

- `torch.cummax(torch.where(mask, lane, -1))` against
  `countstep.last_set_lane(mask)`, also at the -b24 gate post's batch
  (16,777,156 lanes, runs of 8), where `countstep._runs` takes
  `torch.cummax` today;
- `torch.cumsum` of the [8, M] planes along dim 1 against one cumsum of
  their concatenation;
- `triobin_reduce` and `trioeval_mark_mid` as they were first written
  (`torch.cummax`, the cumsum along dim 1; kept below as `*_cummax`)
  against the package's.

Each pair is checked equal first.  Run from the repository root:

    python3 tools/trio_post_probe.py

It prints the card's name and power limit, one line a pair, and last one
JSON object of the times (ms a call; two blocks of 20 calls each, run as
first, second, second, first).
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from yak_tpu_torch.ops import countstep  # noqa: E402

M = 8_388_578          # a 2^23-base chunk at k = 31
GATE_B = 16_777_156    # a -b24 fold's batch (two chunks)
REPS = 20


def cummax_last(mask):
    lane = torch.arange(mask.numel(), dtype=torch.int32, device=mask.device)
    return torch.cummax(torch.where(mask, lane, -1), 0).values


def cumsum_rows(x):
    return torch.cat([x.new_zeros(x.shape[0], 1),
                      torch.cumsum(x, 1, dtype=torch.int32)], 1)


def cumsum_flat(x):
    return countstep._cumsum0(x.reshape(-1))


def type_runs_cummax(typ):
    lane = torch.arange(typ.numel(), dtype=torch.int32, device=typ.device)
    fill = typ.new_full((1,), -1)
    run_start = cummax_last(typ != torch.cat([fill, typ[:-1]]))
    is_end = typ != torch.cat([typ[1:], fill])
    return lane, run_start, lane - run_start + 1, is_end


def triobin_reduce_cummax(flag, typ, valid, meta, k, M):
    bounds, we = meta[:-1], meta[-1]
    lane, run_start, runlen, is_end = type_runs_cummax(typ)
    strk = (is_end & (typ > 0) & (runlen >= k - 4) & (run_start > 0)
            & (lane < we))
    x = torch.stack([valid] + [valid & (flag == v) for v in (0, 1, 2, 4, 8)]
                    + [torch.where(strk & (typ == t), runlen, 0)
                       for t in (1, 2)]).to(torch.int32)
    cs = cumsum_rows(x)
    bc = torch.clamp(bounds, 0, M).to(torch.int64)
    sums = cs[:, bc[1:]] - cs[:, bc[:-1]]
    at_we = lane == we
    scalars = torch.stack([typ[0], (run_start == 0).sum(dtype=torch.int32),
                           torch.where(at_we, typ, 0).sum(dtype=torch.int32),
                           torch.where(at_we, runlen, 0)
                           .sum(dtype=torch.int32)])
    return torch.cat([sums.reshape(-1), scalars])


def trioeval_mark_mid_cummax(typ, we, min_n, M):
    lane, run_start, runlen, is_end = type_runs_cummax(typ)
    emit = is_end & (typ > 0) & ((runlen >= min_n) | (run_start == 0)
                                 | (lane == we))
    return (torch.where(emit, lane, countstep.MARK_DROP), (runlen << 2) | typ,
            emit.sum(dtype=torch.int32))


def device_ms(fn):
    """Device ms a call: REPS calls queued behind a spin, between events
    (torch.cuda._sleep is a private helper of PyTorch's own tests)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / REPS


def same(a, b):
    if isinstance(a, tuple):
        return all(same(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def trio_stream(n, mean_run, seed, dev):
    """Seeded table values in runs (pat-strong 2, mat-strong 8, both 10,
    weak 1 and 4, absent -1), and the validity."""
    rng = np.random.default_rng(seed)
    runs = rng.geometric(1 / mean_run, n)
    vals = np.repeat(rng.choice(np.array([2, 8, 10, 1, 4, -1], np.int32),
                                len(runs)), runs)[:n]
    valid = rng.random(n) < 0.999
    return (torch.from_numpy(vals).to(dev), torch.from_numpy(valid).to(dev))


def main():
    if not torch.cuda.is_available():
        print("trio_post_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    vals, valid = trio_stream(M, 25, 9, dev)
    flag, typ = countstep.trio_types(vals, valid)
    startm = typ != torch.cat([typ.new_full((1,), -1), typ[:-1]])
    gvals, _ = trio_stream(GATE_B, 8, 10, dev)
    gate_heads = gvals != torch.cat([gvals.new_full((1,), -9), gvals[:-1]])
    ns = 4096
    meta = np.full(ns + 2, M, np.int32)
    meta[:4] = [0, 2_000_000, 4_000_000, 6_000_000]
    meta[-1] = M - 1
    meta = torch.from_numpy(meta).to(dev)
    x = torch.stack([valid] + [valid & (flag == v) for v in (0, 1, 2, 4, 8)]
                    + [typ, typ]).to(torch.int32)

    def rows_from_flat():
        cs = cumsum_flat(x)
        return cs[1:].reshape(8, M) - cs[:-1:M].reshape(8, 1)

    pairs = {
        "run starts, trio": (lambda: cummax_last(startm),
                             lambda: countstep.last_set_lane(startm)),
        "run starts, -b24 gate post": (
            lambda: cummax_last(gate_heads),
            lambda: countstep.last_set_lane(gate_heads)),
        "eight-plane prefix sum": (lambda: cumsum_rows(x)[:, 1:],
                                   rows_from_flat),
        "triobin_reduce": (
            lambda: triobin_reduce_cummax(flag, typ, valid, meta, 31, M),
            lambda: countstep.triobin_reduce(flag, typ, valid, meta, 31, M)),
        "trioeval_mark_mid": (
            lambda: trioeval_mark_mid_cummax(typ, M - 1, 2, M),
            lambda: countstep.trioeval_mark_mid(typ, M - 1, 2, M)),
    }
    out = {}
    for name, (first, second) in pairs.items():
        if not same(first(), second()):
            raise AssertionError(f"{name}: the two versions differ")
        a1, b1, b2, a2 = (device_ms(f) for f in (first, second, second,
                                                  first))
        out[name] = {"first": [a1, a2], "second": [b1, b2]}
        print(f"{name}: first {a1:.4f}, {a2:.4f} ms; second {b1:.4f}, "
              f"{b2:.4f} ms (device only) [{card}]", flush=True)
    print(json.dumps({"card": card, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
