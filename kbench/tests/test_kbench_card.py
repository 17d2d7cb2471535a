"""The harness on the card at tiny sizes: the kernels' path, the traced
run's device metrics, the faults and the control there too.  Run on the
chip: `python -m pytest kbench/tests -m card`."""

import time

import pytest

from kbench import control, harness
from test_kbench_harness import CELLS, FAULTS, add_extract_metrics

pytestmark = pytest.mark.card


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(tiny, card, cell):
    for trace in (0, 1):
        r = harness.run_cell(tiny, cell, 2 ** 31 + 3, 0.01, trace, card,
                             time.perf_counter())
        assert r["correct"], r["checks"]
        assert r["device"]["platform"] == "gpu"
        assert r["device"]["memory_peak_bytes"] > 0
    names = set(r["metrics"])
    if cell.startswith("sr"):
        assert {"device_idle_pct.count", "merge_roofline.count",
                "gate_post_ms_per_mlane", "ingest_wait_pct.count"} <= names
    else:
        assert {"device_idle_pct.lookup", "join_roofline.lookup",
                "ingest_wait_pct.lookup", "qv_host_fold_pct.lookup"} <= names
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["breakdown"]["device_ops"]


def test_new_metric_reads_its_device_time(tiny, card):
    add_extract_metrics(tiny)
    r = harness.run_cell(tiny, "sr-k31.count-b37", 2 ** 31 + 9, 0.01, 1,
                         card, time.perf_counter())
    assert r["correct"]
    assert r["metrics"]["dummy_extract_calls"]["value"] > 0
    assert r["metrics"]["dummy_extract_ms"]["value"] > 0


@pytest.mark.parametrize("cell,mod,name,fault", FAULTS,
                         ids=[f"{c}-{n}" for c, _m, n, _f in FAULTS])
def test_planted_fault_on_the_card(tiny, card, monkeypatch, cell, mod, name,
                                   fault):
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    r = harness.run_cell(tiny, cell, 5, 0.01, 0, card, time.perf_counter())
    assert not r["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(tiny, card, cell):
    c = harness.find_cell(tiny, cell)
    for seed in (1, 2, 3):
        nums = control.control_numbers(c.cfg, c.mix, seed, card)
        assert any(v > harness.LIMIT for v in nums.values()), nums
