"""Device milliseconds of the -b gate post (`countstep.
run_bloom_gate_post`) a million lanes it was given: per lane, as a
fold's size follows the table's capacity."""

from kbench.spans import call

SPANS = [call("yak_tpu_torch.ops.countstep:run_bloom_gate_post", "gate_post",
              lambda a, out: {"lanes": a["bkeys"].numel()})]


def read(run):
    calls = run.spans.calls.get("gate_post") if run.spans else None
    dev_s = run.trace.device_s_in("gate_post") if run.trace else None
    if not calls or not dev_s:
        return None
    return dev_s * 1e3 / (sum(c["lanes"] for c in calls) / 1e6)
