"""The JOIN kernel's share of its byte bound (`roofline.join_bytes` at
each call's sizes over the device time of the operations the call
launched), over all its calls in the window."""

from kbench import roofline
from kbench.readers import roofline_pct
from kbench.spans import call

SPANS = [call("yak_tpu_torch.ops.merge:merge_join", "merge_join",
              lambda a, out: {"live": a["size"].clone(),
                              "n_queries": a["qkeys"].numel()})]


def read(run):
    return roofline_pct(run, "merge_join", lambda c: roofline.join_bytes(
        c["live"], c["n_queries"]))
