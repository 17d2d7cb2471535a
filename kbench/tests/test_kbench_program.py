"""The program's own spans in the benchmark (`kbench/program.py` and the
metrics that read it): the three metrics on a synthetic run, the
record taken once and cleared, a program without `yak_tpu_torch.spans`
(nothing new read, nothing raised), and the program's kernel, gate and
reader spans against the benchmark's own wrappers on one small job of
each cell on the CPU."""

import sys
import time
import warnings
from collections import Counter

import pytest
import torch

import yak_tpu_torch
from conftest import REPO
from kbench import harness, program
from kbench.spans import Spans
from yak_tpu_torch import spans as prog_spans
# the program's modules load before a test hides its spans module
from yak_tpu_torch.models import count, qv  # noqa: F401

METRICS = REPO / "kbench" / "metrics"
NEW = ["reader_fill_pct.lookup", "reader_busy_pct.lookup",
       "qv_job_fixed_pct.lookup"]
# the traced run's metrics on the CPU before the program's spans
OLD = {"sr-k31.count-b37": {"ingest_wait_pct.count"},
       "asm-k31.qv": {"ingest_wait_pct.lookup", "qv_host_fold_pct.lookup"}}


class _Run:
    """A run of one job of 1 ms with the program's record `program`."""

    def __init__(self, program):
        self.jobs = [(5.0, 5.001)]
        self.jobs_s = 1e-3
        self.program = program


def test_new_metrics_read_a_synthetic_run():
    mods = {n: harness.load_module(METRICS / f"{n}.py") for n in NEW}
    run = _Run({"spans": {"reader.fill": (2, 1.5e-4), "qv.hist": (1, 2e-4),
                          "qv.solve": (1, 5e-5), "qv.fold": (3, 4e-4)},
                "counters": {"reader.input_s": 1e-4, "reader.parse_s": 2e-4,
                             "reader.pack_s": 1e-4, "reader.full_s": 5e-4}})
    got = {n: m.read(run) for n, m in mods.items()}
    assert got["reader_fill_pct.lookup"] == pytest.approx(15.0)
    assert got["reader_busy_pct.lookup"] == pytest.approx(40.0)
    assert got["qv_job_fixed_pct.lookup"] == pytest.approx(25.0)
    assert program.host_s(run, ("table.stage",)) is None
    # a record without the reader's counters or spans gives nothing
    bare = _Run({"spans": {"qv.fold": (3, 4e-4)}, "counters": {}})
    assert all(m.read(bare) is None for m in mods.values())
    none = _Run(None)
    assert all(m.read(none) is None for m in mods.values())


def test_record_taken_once_and_cleared(capsys):
    """The first reading takes the program's record and clears it; a
    later reading of the same run reads what was taken."""
    prog_spans.reset()
    prog_spans.enable()
    try:
        with prog_spans.span("qv.hist"):
            pass
        prog_spans.count("reader.pack_s", 0.5)
    finally:
        prog_spans.enable(False)
    run = _Run(None)
    del run.program
    assert program.host_s(run, ("qv.hist",)) >= 0
    assert program.counter(run, "reader.pack_s") == 0.5
    assert prog_spans.snapshot() == {"spans": {}, "counters": {}}
    assert run.program["spans"]["qv.hist"][0] == 1
    err = capsys.readouterr().err
    assert "the program's spans, host s (calls): qv.hist" in err
    assert "the program's counters: reader.pack_s 0.500000" in err


@pytest.mark.parametrize("cell", ["sr-k31.count-b37", "asm-k31.qv"])
def test_without_the_programs_spans(tiny, monkeypatch, cell):
    """A program older than its spans: the traced run reads every metric
    it read before and none of the new ones."""
    monkeypatch.delattr(yak_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "yak_tpu_torch.spans", None)
    r = harness.run_cell(tiny, cell, 2 ** 31 + 5, 0.01, 1, "cpu",
                         time.perf_counter())
    assert r["correct"]
    assert set(r["metrics"]) == OLD[cell]


class _Counting(Spans):
    def __init__(self, wraps):
        super().__init__(wraps)
        self.n = Counter()

    def span(self, name):
        self.n[name] += 1
        return super().span(name)


@pytest.mark.parametrize("cell", ["sr-k31.count-b37", "asm-k31.qv"])
def test_program_spans_match_the_benchmarks_wrappers(tiny, tmp_path, cell):
    """One job: the program's kernel.merge_reduce, kernel.merge_join and
    gate.post see the calls the metrics' wrappers record,
    and its reader spans the chunks the ingest wrapper waits for."""
    c = harness.find_cell(tiny, cell)
    job = c.job.make(c.cfg, c.mix, 2 ** 31 + 13, "cpu", str(tmp_path))
    outer = _Counting(c.spans).install()
    prog_spans.reset()
    prog_spans.enable()
    try:
        job.run()
    finally:
        prog_spans.enable(False)
        outer.remove()
    outer.settle()
    snap = prog_spans.snapshot()
    prog_spans.reset()
    pairs = {"merge_reduce": "kernel.merge_reduce",
             "merge_join": "kernel.merge_join", "gate_post": "gate.post"}
    assert set(outer.calls) <= set(pairs)
    for theirs, ours in pairs.items():
        if theirs in outer.calls:
            assert len(outer.calls[theirs]) == snap["spans"][ours][0], theirs
    calls = {n: s[0] for n, s in snap["spans"].items()}
    readers = calls["reader.fill"]
    assert readers == (2 if cell.startswith("sr") else 1)
    # every wait for a chunk, the last one finding the end
    assert outer.n["ingest"] == calls["reader.fill"] + calls["reader.wait"]
    assert calls["reader.copy"] == outer.n["ingest"] - readers


# -- on the card -----------------------------------------------------------

CELLS = ["sr-k31.count-b37", "asm-k31.qv"]
NEW_IN = {"sr-k31.count-b37": set(),
          "asm-k31.qv": {"reader_fill_pct.lookup", "reader_busy_pct.lookup",
                         "qv_job_fixed_pct.lookup"}}


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_program_on_the_card(tiny, card, capsys, cell):
    """The new metrics of a traced run, from the program's record of its
    window (cleared first: a run of the benchmark is a process of its
    own, and the harness does not reset the record yet)."""
    prog_spans.reset()
    r = harness.run_cell(tiny, cell, 2 ** 31 + 19, 0.01, 1, card,
                         time.perf_counter())
    assert r["correct"]
    got = {n: m["value"] for n, m in r["metrics"].items() if n in NEW}
    assert set(got) == NEW_IN[cell]
    assert all(0 <= v <= 100 for v in got.values()), got
    # the record is read, and logged, where a metric reads it
    assert ("the program's spans, host s" in capsys.readouterr().err) \
        == bool(NEW_IN[cell])
    prog_spans.reset()


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_spans_add_no_sync_on_the_card(tiny, card, tmp_path, cell):
    """torch.cuda's sync debug mode reports the same synchronising calls,
    by the line that made them, in a job with spans on as with them
    off."""
    c = harness.find_cell(tiny, cell)
    job = c.job.make(c.cfg, c.mix, 2 ** 31 + 17, card, str(tmp_path))
    job.warm()
    job.run()
    syncs = []
    for on in (False, True):
        prog_spans.reset()
        prog_spans.enable(on)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    job.run()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
        finally:
            prog_spans.enable(False)
        # (the debug mode's own setter warns once, at its first use)
        syncs.append(Counter((w.filename, w.lineno) for w in caught
                             if "synchroniz" in str(w.message)
                             and w.filename != torch.cuda.__file__))
    prog_spans.reset()
    assert syncs[0], "the debug mode reported none of the job's syncs"
    assert syncs[1] == syncs[0]
