"""The roofline rules against bytes counted by hand, the spans' capture
of a call's sizes, and the reading of a profiler trace."""

import pytest
import torch

from conftest import REPO
from kbench import harness, readers, roofline
from kbench.spans import Spans
from kbench.trace import Trace
from yak_tpu_torch.ops import merge
from yak_tpu_torch.ops.keys import INT64_MAX

METRICS = REPO / "kbench" / "metrics"


def declared(*names):
    """The spans that the metric files `names` (every one if none)
    declare."""
    files = [METRICS / f"{n}.py" for n in names] or sorted(
        METRICS.glob("*.py"))
    return [w for f in files
            for w in getattr(harness.load_module(f), "SPANS", ())]


def test_merge_rule_against_a_hand_count():
    """A table of 8 slots, 5 live; a batch of 4 keys, one of them invalid
    (INT64_MAX), two of them new: 5 keys and counts read (60 B), 3
    batch keys read (24 B; 36 B with their weights), 7 keys and counts
    written (84 B)."""
    tkeys = torch.tensor([2, 4, 6, 8, 10, 0, 0, 0])
    tcnt = torch.tensor([1, 1, 1, 1, 1, 0, 0, 0], dtype=torch.int32)
    size = torch.tensor(5, dtype=torch.int32)
    bkeys = torch.tensor([3, 4, 5, INT64_MAX])
    spans = Spans(declared("merge_roofline.count")).install()
    try:
        out = merge.merge_reduce(tkeys, tcnt, size, bkeys, True)
        assert int(out[2]) == 7
        weights = torch.ones(4, dtype=torch.int32)
        merge.merge_reduce(tkeys, tcnt, size, bkeys, True, weights=weights)
    finally:
        spans.remove()
    spans.settle()
    plain, weighted = spans.calls["merge_reduce"]
    assert plain == {"live": 5, "batch_valid": 3, "new_size": 7, "cap": 8,
                     "weighted": False}
    assert weighted["weighted"]
    assert roofline.merge_bytes(5, 3, 7, 8, False) == 60 + 24 + 84
    assert roofline.merge_bytes(5, 3, 7, 8, True) == 60 + 36 + 84
    # a new size past the capacity writes the capacity
    assert roofline.merge_bytes(5, 3, 9, 8, False) == 60 + 24 + 96


def test_join_rule_against_a_hand_count():
    """5 live keys and counts read (60 B); 6 queries: key and lane read,
    value written (96 B)."""
    tkeys = torch.tensor([2, 4, 6, 8, 10, 0, 0, 0])
    tcnt = torch.arange(8, dtype=torch.int32)
    size = torch.tensor(5, dtype=torch.int32)
    q = torch.tensor([1, 2, 6, 7, 10, INT64_MAX])
    spans = Spans(declared("join_roofline.lookup")).install()
    try:
        vals = merge.merge_join(tkeys, tcnt, size, q,
                                torch.arange(6, dtype=torch.int32))
    finally:
        spans.remove()
    assert vals.tolist() == [-1, 0, 2, -1, 4, -1]
    spans.settle()
    assert spans.calls["merge_join"] == [{"live": 5, "n_queries": 6}]
    assert roofline.join_bytes(5, 6) == 60 + 96
    assert roofline.seconds(3.35e12) == pytest.approx(1.0)


def test_spans_keep_the_wrapped_functions_attributes():
    """The kernels' wrappers count their launches on the function that
    the module names; the spans' wrappers must carry those counters."""
    old = (merge.merge_reduce, merge.merge_join)
    spans = Spans(declared()).install()
    try:
        assert merge.merge_reduce is not old[0]
        assert merge.merge_reduce.launches == old[0].launches
        assert merge.merge_reduce.mode_launches is old[0].mode_launches
        assert merge.merge_join.launches == old[1].launches
    finally:
        spans.remove()
    assert (merge.merge_reduce, merge.merge_join) == old


def test_spans_are_the_union_of_the_cells_metrics(tiny):
    """A cell's traced run wraps what its per-layer metrics declare, once
    each, and `remove` puts every attribute back."""
    want = {"sr-k31.count-b37": {"ingest", "gate_post", "merge_reduce"},
            "asm-k31.qv": {"ingest", "merge_join", "qv_host_fold"}}
    for cell, names in want.items():
        wraps = harness.find_cell(tiny, cell).spans
        assert {w.span for w in wraps} == names
        spans = Spans(wraps + wraps)
        assert len(spans.wraps) == len(wraps)
        old = [getattr(__import__(w.module, fromlist=["_"]), w.attr)
               for w in spans.wraps]
        spans.install()
        spans.remove()
        assert old == [getattr(__import__(w.module, fromlist=["_"]), w.attr)
                       for w in spans.wraps]


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


EVENTS = [
    _x("user_annotation", "kbench.window", 0, 1000),
    _x("user_annotation", "kbench.job", 0, 1000),
    _x("user_annotation", "kbench.merge_reduce", 100, 50),
    _x("user_annotation", "kbench.ingest", 400, 300),
    _x("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=1),
    _x("cuda_runtime", "cudaMemsetAsync", 120, 5, corr=2),
    _x("cuda_runtime", "cudaLaunchKernel", 300, 5, corr=3),
    _x("kernel", "merge_main", 200, 100, corr=1),
    _x("gpu_memset", "Memset (Device)", 250, 100, corr=2),
    _x("kernel", "sort", 800, 300, corr=3),       # runs past the window
    _x("cpu_op", "aten::sort", 300, 10),
    {"ph": "M", "name": "process_name"},
]


def test_trace_busy_idle_and_attribution():
    t = Trace(EVENTS)
    assert t.window_s == pytest.approx(1e-3)
    # device busy [200, 350) and [800, 1000)
    assert t.busy_s == pytest.approx(350e-6)
    assert t.device_s_in("merge_reduce") == pytest.approx(200e-6)
    assert t.device_s_in("gate_post") is None
    b = t.breakdown()
    assert b["device_ops"][0] == ["sort", pytest.approx(200e-6)]
    idle = dict((k, v) for k, v in b["idle_gaps"])
    # each gap goes to the innermost span at its middle: [0, 200) to
    # the merge's launch (at 100), [350, 800) to the ingest (at 575)
    assert idle == {"kbench.merge_reduce": pytest.approx(200e-6),
                    "kbench.ingest": pytest.approx(450e-6)}


class _Run:
    def __init__(self, trace, spans=None):
        self.trace, self.spans, self.jobs_s = trace, spans, 1e-3


def test_readers_of_the_trace():
    t = Trace(EVENTS)
    assert readers.device_idle_pct(_Run(t)) == pytest.approx(65.0)
    spans = Spans()
    spans.calls["merge_reduce"].append({"live": 0, "batch_valid": 0,
                                        "new_size": 0, "cap": 1,
                                        "weighted": False})
    spans.host_s["ingest"] = 0.25e-3
    run = _Run(t, spans)
    pct = readers.roofline_pct(run, "merge_reduce", lambda c: 3.35e12 * 1e-4)
    assert pct == pytest.approx(100 * 1e-4 / 200e-6)
    assert readers.roofline_pct(run, "merge_join", lambda c: 1) is None
    assert readers.ingest_wait_pct(run) == pytest.approx(25.0)
    assert readers.device_idle_pct(_Run(None)) is None
