"""The rules that the metric files under `metrics/` apply, each to a
finished run (`harness.Run`); a rule returns None where the run holds
nothing for it to read."""

from kbench import roofline
from kbench.spans import each_item

# the wait for each chunk, through the name the count and qv models
# take `ChunkSource` by
INGEST_SPANS = [each_item(f"yak_tpu_torch.models.{m}:ChunkSource", "ingest")
                for m in ("count", "qv")]


def rate(run):
    """The window's work over its time, first job's start to last job's
    end (host clock)."""
    return run.work / run.window_s


def device_idle_pct(run):
    """Share of the traced window in which no kernel, copy or memset ran
    on the card."""
    t = run.trace
    if t is None or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def ingest_wait_pct(run):
    """Share of the jobs' wall that the program spent waiting for its
    next chunk from `ChunkSource` (host clock)."""
    if run.spans is None or "ingest" not in run.spans.host_s:
        return None
    return 100.0 * run.spans.host_s["ingest"] / run.jobs_s


def roofline_pct(run, span, nbytes):
    """Sum over the span's calls of the byte bound (`nbytes(call)`) over
    the device time of the operations those calls launched."""
    calls = run.spans.calls.get(span) if run.spans else None
    dev_s = run.trace.device_s_in(span) if run.trace and calls else None
    if not dev_s:
        return None
    bound_s = sum(roofline.seconds(nbytes(c)) for c in calls)
    return 100.0 * bound_s / dev_s
