"""Progress lines in the reference's `[M::func::real*cpu]` shape
(count.c:140-141, sys.c), the lookup workloads' 2-deep pipeline with
its copies to the host, and the YAK_TPU_PROFILE trace."""

import contextlib
import os
import sys
import time

import numpy as np
import torch

from yak_tpu_torch.io.chunks import ChunkSource


class Progress:
    """Reference-shaped per-chunk progress lines:
    `[M::<name>::<real>*<cpu/real>] <message>` (count.c:140-141)."""

    def __init__(self, name):
        self.name = name
        self.t0 = time.time()
        self.c0 = time.process_time()

    def line(self, msg):
        rt = time.time() - self.t0
        cpu = time.process_time() - self.c0
        print(f"[M::{self.name}::{rt:.3f}*{(cpu / rt if rt else 0):.2f}] "
              f"{msg}", file=sys.stderr)


def to_host_async(tensors):
    """Start copies of `tensors` (on one device) to pinned host memory on
    their device's current stream; returns the host tensors and an event
    that is done when they are (None for CPU tensors, returned as they
    are)."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return tuple(tensors) + (None,)
    host = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(dev))
    return tuple(host) + (ready,)


def settle(host):
    """Wait for a to_host_async result; returns its host tensors."""
    *host, ready = host
    if ready is not None:
        ready.synchronize()
    return host


def lookup_pipeline(seq_fn, chunk, k, dispatch):
    """The lookup workloads' 2-deep dispatch/consume pipeline (the role
    of kt_pipeline's read/compute overlap): chunk i is queued on the
    device by `dispatch` before the host folds chunk i-1, whose results
    were copied to the host behind an event of their own.  Yields
    (packed, dispatch(packed)) in input order, records-meta chunks with
    at least one record."""
    pending = []
    for packed in ChunkSource(seq_fn, chunk, k, with_meta="records"):
        if not len(packed.rec_gid):
            continue
        pending.append((packed, dispatch(packed)))
        if len(pending) >= 2:
            yield pending.pop(0)
    yield from pending


def host_markers(planes, n, a, b, maxr):
    """A chunk's n markers as int64 numpy arrays: the first `maxr` lanes
    of the two marker planes were copied ahead (a, b, settled); past the
    budget all n come from the planes, still on the device."""
    n = int(n)
    if n > maxr:
        a, b = planes[0][:n].cpu(), planes[1][:n].cpu()
    return a[:n].numpy().astype(np.int64), b[:n].numpy().astype(np.int64)


@contextlib.contextmanager
def maybe_profile(device=None):
    """YAK_TPU_PROFILE=<dir>: a `torch.profiler` trace of the block
    (yak_tpu/utils.py:38-64, the JAX profiler there), host activity and,
    on a CUDA `device`, the card's, written as one Chrome trace
    (`trace-<pid>.json`, for chrome://tracing or Perfetto) into <dir>
    when the block ends, however it ends; the program's spans
    (`spans.py`, ranges `yak.*`) are on while it records.  A no-op when
    unset."""
    out = os.environ.get("YAK_TPU_PROFILE")
    if not out:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device is not None and device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    try:
        with prof:
            yield
    finally:
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out,
                                              f"trace-{os.getpid()}.json"))
        print(f"[M::yak_tpu_torch] profiler trace written to {out}",
              file=sys.stderr)
