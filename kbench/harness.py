"""One run of one cell: find the cell's configuration, traffic mix, job
and metrics by name, set up, run whole jobs back to back for the
window, check the outputs against the plain reference, and build the
result line.

Everything a cell is made of is found under the benchmark's root by
the names in BENCHMARK.json, so a later cell adds files and entries:

  kbench/configs/<config>.json   the deployment: data scale and shapes
  kbench/traffic/<traffic>.json  the job the window repeats and its
                                 options; "job" names its kind
  kbench/jobs/<job>.py           a kind of job: make(cfg, mix, seed,
                                 device, tmp) -> an object with work
                                 (units a job), setup_parts, warm(),
                                 run(), keep(out, last) and check() ->
                                 (numbers, jobs wrong)
  kbench/metrics/<metric>.py     read(run) -> the metric, or None; a
                                 per-layer metric's SPANS: the spans
                                 the traced run records for it
                                 (spans.py)
"""

import importlib.util
import json
import os
import resource
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

LIMIT = 0      # every comparison is exact (compare.py)


def log(msg):
    print(f"[kbench] {msg}", file=sys.stderr, flush=True)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """A module of the benchmark's own files, found by its path (names
    such as `ingest_wait_pct.count` are no module names)."""
    name = "kbench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A workload of BENCHMARK.json with what it names."""
    name: str
    chips: int
    cfg: dict
    mix: dict
    job: object
    metrics: dict = field(default_factory=dict)   # trace 0/1 -> {name: unit}
    spans: list = field(default_factory=list)     # the traced run's Wraps


def find_cell(root, workload):
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    w = cells[workload]
    kb = root / "kbench"
    mix = load_json(kb / "traffic" / f"{w['traffic']}.json")
    cell = Cell(workload, w["chips"],
                load_json(kb / "configs" / f"{w['config']}.json"), mix,
                load_module(kb / "jobs" / f"{mix['job']}.py"))
    for trace, key in ((0, "end_to_end"), (1, "per_layer")):
        cell.metrics[trace] = {
            m["name"]: (m["unit"], load_module(kb / "metrics"
                                               / f"{m['name']}.py"))
            for m in bench[key] if workload in m.get("workloads", cells)}
    cell.spans = [w for _unit, mod in cell.metrics[1].values()
                  for w in getattr(mod, "SPANS", ())]
    return cell


@dataclass
class Run:
    """What the metric files read."""
    setup_s: float
    work: int = 0
    jobs: list = field(default_factory=list)      # [(start, end)] host s
    peak_bytes: int = None
    spans: object = None
    trace: object = None
    cpu_s: float = 0.0      # the process's CPU seconds in the window
    preempted: int = 0      # its involuntary context switches there

    @property
    def window_s(self):
        return self.jobs[-1][1] - self.jobs[0][0]

    @property
    def jobs_s(self):
        return sum(t - s for s, t in self.jobs)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(root, workload, seed, seconds, trace, device, t_start):
    """One run of `workload`; returns the result line's object.  t_start:
    the run's start on `time.perf_counter`'s clock."""
    cell = find_cell(root, workload)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="kbench-") as tmp:
        parts = {"start and imports": time.perf_counter() - t_start}
        job = cell.job.make(cell.cfg, cell.mix, seed, device, tmp)
        parts.update(job.setup_parts)
        t = time.perf_counter()
        job.warm()
        sync(device)
        parts["warm-up job"] = time.perf_counter() - t
        run = Run(setup_s=time.perf_counter() - t_start)
        log(f"{workload}: set-up {run.setup_s:.3f} s ("
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
            + f"), {job.work} work units a job")
        prof = spans = None
        if trace:
            from kbench.spans import Spans
            from torch.profiler import ProfilerActivity, profile

            spans = Spans(cell.spans).install()
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        try:
            _window(job, run, seconds, device, spans)
        finally:
            if spans is not None:
                spans.remove()
            if prof is not None:
                prof.__exit__(None, None, None)
        if cuda:
            run.peak_bytes = torch.cuda.max_memory_allocated(dev)
        walls = sorted(t - s for s, t in run.jobs)
        log(f"{len(walls)} jobs in {run.window_s:.3f} s: wall min "
            f"{walls[0]:.4f}, median {walls[len(walls) // 2]:.4f}, max "
            f"{walls[-1]:.4f} s; host CPU {run.cpu_s:.3f} s "
            f"({100 * run.cpu_s / run.window_s:.1f} % of the window), "
            f"{run.preempted} involuntary context switches")
        run.spans = spans
        if prof is not None:
            from kbench.trace import Trace

            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            prof = None
            run.trace = Trace.load(path)
        numbers, wrong = job.check()
    metrics = {}
    for name, (unit, mod) in cell.metrics[int(bool(trace))].items():
        v = mod.read(run)
        if v is not None:
            metrics[name] = {"value": v, "unit": unit}
    result = {
        "correct": all(v <= LIMIT for v in numbers.values()),
        "attempted": len(run.jobs), "failed": wrong, "metrics": metrics,
        "device": device_info(dev, run)}
    if run.trace is not None and run.trace.ops:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": LIMIT}
                        for k, v in numbers.items()}
    return result


def _window(job, run, seconds, device, spans):
    """Whole jobs back to back until `seconds` have passed since the first
    one started; the job running then is finished and counted."""
    from torch.profiler import record_function

    r0 = resource.getrusage(resource.RUSAGE_SELF)
    with record_function("kbench.window"):
        w0 = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            with record_function("kbench.job"):
                out = job.run()
                sync(device)
            t1 = time.perf_counter()
            run.jobs.append((t0, t1))
            run.work += job.work
            last = t1 - w0 >= seconds
            job.keep(out, last)
            del out
            if spans is not None:
                spans.settle()
            if last:
                break
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    run.cpu_s = (r1.ru_utime + r1.ru_stime) - (r0.ru_utime + r0.ru_stime)
    run.preempted = r1.ru_nivcsw - r0.ru_nivcsw


def device_info(dev, run):
    if dev.type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": 1, "memory_peak_bytes": run.peak_bytes}
    if run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info
