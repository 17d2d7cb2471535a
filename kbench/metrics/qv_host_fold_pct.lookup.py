"""Share of the jobs' wall from the return of each chunk's qv post to
the end of `models.qv._qv_out_update`: the chunk's sync and the host's
per-sequence fold under -p (host clock)."""

from kbench.spans import close_after, open_after

SPANS = [open_after("yak_tpu_torch.ops.countstep:qv_join_post",
                    "qv_host_fold"),
         close_after("yak_tpu_torch.models.qv:_qv_out_update",
                     "qv_host_fold")]


def read(run):
    if run.spans is None or "qv_host_fold" not in run.spans.host_s:
        return None
    return 100.0 * run.spans.host_s["qv_host_fold"] / run.jobs_s
