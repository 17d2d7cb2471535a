"""The merge-reduce kernel's share of its byte bound (`roofline.
merge_bytes` at each call's sizes over the device time of the
operations the call launched), over all its calls in the window."""

import torch

from kbench import roofline
from kbench.readers import roofline_pct
from kbench.spans import call

INVALID = torch.iinfo(torch.int64).max      # a batch lane with no key


def sizes(a, out):
    return {"live": a["size"].clone(),
            "batch_valid": (a["bkeys"] != INVALID).sum(),
            "new_size": out[2].clone(), "cap": a["tkeys"].numel(),
            "weighted": a["weights"] is not None}


SPANS = [call("yak_tpu_torch.ops.merge:merge_reduce", "merge_reduce", sizes)]


def read(run):
    return roofline_pct(run, "merge_reduce", lambda c: roofline.merge_bytes(
        c["live"], c["batch_valid"], c["new_size"], c["cap"],
        c["weighted"]))
