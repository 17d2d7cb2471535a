"""What the program records of itself in the traced run: the calls and
host seconds of the spans of `yak_tpu_torch.spans` and its counters,
read once after the window and logged.

The spans are on while a `torch.profiler` profile records, which in
the traced run is the window alone (the warm-up job runs before the
profiler starts, the check after it stops), so the record is the
window's.  The spans' ranges themselves are in the profiler's trace as
`yak.<name>`, on its clock, beside the benchmark's `kbench.*` ranges.
A program without that module (one older than its spans) gives None,
and the metrics that read it give nothing."""

from kbench.harness import log

TOP = 12        # the spans logged


def snapshot(run):
    """The program's record of the window (`spans.snapshot()`), taken at
    the first reading and kept on the run; the record is then cleared,
    so that a later run of the same process starts empty.  None without
    the module."""
    if not hasattr(run, "program"):
        try:
            from yak_tpu_torch import spans
        except ImportError:
            run.program = None
            return None
        run.program = spans.snapshot()
        spans.reset()
        host = sorted(run.program["spans"].items(), key=lambda kv: -kv[1][1])
        log("the program's spans, host s (calls): " + ", ".join(
            f"{k} {s:.6f} ({n})" for k, (n, s) in host[:TOP]))
        counters = sorted(run.program["counters"].items())
        log("the program's counters: " + ", ".join(
            f"{k} {v:.6f}" for k, v in counters))
    return run.program


def host_s(run, names):
    """Host seconds of the program's spans `names`; None where the
    program recorded none of them."""
    snap = snapshot(run)
    found = [] if snap is None else [snap["spans"][n] for n in names
                                     if n in snap["spans"]]
    return sum(s for _calls, s in found) if found else None


def counter(run, name):
    snap = snapshot(run)
    return None if snap is None else snap["counters"].get(name)


def pct_of_jobs(run, seconds):
    return None if seconds is None else 100.0 * seconds / run.jobs_s
