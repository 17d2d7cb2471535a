"""The harness on the CPU at tiny sizes: the result line, discovery by
name, the refusals of the command, and `correct` under planted faults
and under the control."""

import functools
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import REPO
from kbench import control, harness
from kbench.run import forbidden_modules
from yak_tpu_torch.models import qv as m_qv
from yak_tpu_torch.ops import countstep, merge

CELLS = ["sr-k31.count-b37", "asm-k31.qv"]
SEED = 2 ** 31 + 7


def run(root, cell, trace=0, seed=SEED):
    return harness.run_cell(root, cell, seed, 0.01, trace, "cpu",
                            time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_keys(tiny, cell):
    r = run(tiny, cell)
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device", "checks"]
    assert r["correct"] and r["attempted"] == 1 and r["failed"] == 0
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    e2e = {m["name"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    # the peak is the card's: a CPU run has none to report
    assert set(r["metrics"]) == e2e - {"peak_dev_mem_gib"}
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_host_spans(tiny, cell):
    r = run(tiny, cell, trace=1)
    assert r["correct"]
    assert r["device"]["window_s"] > 0 and r["device"]["busy_s"] == 0
    kind = cell.split(".")[1].split("-")[0]
    assert f"ingest_wait_pct.{'count' if kind == 'count' else 'lookup'}" \
        in r["metrics"]
    # no card: nothing ran on a device, so no device metric is read
    assert not any("idle" in m or "roofline" in m or "gate" in m
                   for m in r["metrics"])


def test_harness_finds_a_new_mix_and_metric_by_name(tiny):
    """A later cell is new files and new entries: a mix (a count without
    -b), a metric reading the run, and BENCHMARK.json's lines."""
    kb = tiny / "kbench"
    (kb / "traffic" / "count-dummy.json").write_text(json.dumps(
        {"job": "count", "inputs": 1, "bf_shift": 0,
         "chunk_size": 1 << 16}))
    (kb / "metrics" / "dummy_jobs.py").write_text(
        "def read(run):\n    return len(run.jobs)\n")
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sr-k31.count-dummy",
                               "config": "sr-k31", "traffic": "count-dummy",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_jobs", "unit": "jobs",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["sr-k31.count-dummy"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    r = run(tiny, "sr-k31.count-dummy")
    assert r["correct"]
    assert r["metrics"]["dummy_jobs"] == {"value": 1, "unit": "jobs"}
    assert "count_kmers_per_s" not in r["metrics"]


EXTRACT_METRICS = {
    # the traced run's ranges of a span that no file wrapped before
    "dummy_extract_calls": (
        "from kbench.spans import call\n"
        "SPANS = [call('yak_tpu_torch.ops.countstep:extract', 'extract',\n"
        "              lambda a, out: {'lanes': out[1].numel()})]\n"
        "def read(run):\n"
        "    return len(run.trace.ranges.get('kbench.extract', ()))\n"),
    # its device time (None where nothing ran on a device)
    "dummy_extract_ms": (
        "from kbench.spans import call\n"
        "SPANS = [call('yak_tpu_torch.ops.countstep:extract', 'extract')]\n"
        "def read(run):\n"
        "    s = run.trace.device_s_in('extract')\n"
        "    return None if s is None else s * 1e3\n"),
}


def add_extract_metrics(root):
    """Two per-layer metrics over `ops.countstep.extract`, which no file
    of the benchmark wraps, added as new files and entries alone."""
    for name, code in EXTRACT_METRICS.items():
        (root / "kbench" / "metrics" / f"{name}.py").write_text(code)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"] += [
        {"name": name, "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "extraction (ops/countstep)",
         "moves": "count_kmers_per_s", "workloads": ["sr-k31.count-b37"]}
        for name in EXTRACT_METRICS]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_harness_wraps_what_a_new_metric_declares(tiny):
    """A metric over a function that no file wraps yet: its span is
    recorded in the traced run, and none of the harness's files
    changed."""
    add_extract_metrics(tiny)
    extract = countstep.extract
    r = run(tiny, "sr-k31.count-b37", trace=1)
    assert r["correct"]
    assert r["metrics"]["dummy_extract_calls"]["value"] > 0
    # no card: the span holds no device time
    assert "dummy_extract_ms" not in r["metrics"]
    assert countstep.extract is extract


# -- planted faults: each must turn `correct` false -----------------------

def _unchanged_fold(fn):
    """A fold that returns the table it was given."""
    def step(carg, k, tkeys, tcnt, size, create, *a, **kw):
        out = fn(carg, k, tkeys, tcnt, size, create, *a, **kw)
        return (tkeys, tcnt, size) + out[3:]
    return step


def _half_batch(fn):
    """The fold's hashes with half of the lanes left out."""
    def extract(carg, k):
        h, valid = fn(carg, k)
        keep = torch.arange(valid.numel(), device=valid.device).reshape(
            valid.shape) % 2 == 0
        return h, valid & keep
    return extract


def _altered_count(fn):
    """One count of the merge's result changed where it is produced."""
    @functools.wraps(fn)        # the kernel counts its launches on it
    def merge_reduce(*a, **kw):
        okeys, ocnt, size, n_new = fn(*a, **kw)
        ocnt = ocnt.clone()
        ocnt[0] += 1
        return okeys, ocnt, size, n_new
    return merge_reduce


def _unchanged_qv_state(fn):
    def step(state, *a, **kw):
        fn(state, *a, **kw)
        return state
    return step


def _half_lookups(fn):
    def lookup_chunk(*a, **kw):
        vals, valid = fn(*a, **kw)
        lane = torch.arange(valid.numel(), device=valid.device)
        return vals, valid & (lane % 2 == 0)
    return lookup_chunk


def _altered_value(fn):
    """The counts of one in a thousand found windows changed (one alone
    may fall in a contig that -l leaves out)."""
    @functools.wraps(fn)
    def merge_join(*a, **kw):
        vals = fn(*a, **kw).clone()
        found = torch.nonzero(vals >= 0).reshape(-1)
        vals[found[::1000]] += 1
        return vals
    return merge_join


FAULTS = [  # (cell, module, attribute, fault)
    ("sr-k31.count-b37", countstep, "count_step", _unchanged_fold),
    ("sr-k31.count-b37", countstep, "extract", _half_batch),
    ("sr-k31.count-b37", merge, "merge_reduce", _altered_count),
    ("asm-k31.qv", countstep, "qv_fold_step", _unchanged_qv_state),
    ("asm-k31.qv", countstep, "lookup_chunk", _half_lookups),
    ("asm-k31.qv", merge, "merge_join", _altered_value),
]


@pytest.mark.parametrize("cell,mod,name,fault", FAULTS,
                         ids=[f"{c}-{n}" for c, _m, n, _f in FAULTS])
def test_planted_fault_is_not_correct(tiny, monkeypatch, cell, mod, name,
                                      fault):
    """A step returning its state unchanged, half of a batch left out,
    answers altered where they are produced: `correct` comes out false.
    (One chip: there is no exchange between chips to leave out.)"""
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    r = run(tiny, cell)
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
    assert r["failed"] == r["attempted"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny, cell):
    c = harness.find_cell(tiny, cell)
    for seed in (1, 2, 3):
        nums = control.control_numbers(c.cfg, c.mix, seed, "cpu")
        assert any(v > harness.LIMIT for v in nums.values()), nums


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert forbidden_modules() == []
    for name, bad in (("yak_tpu_torch.ops", []), ("yak_tpu.ops", ["yak_tpu"]),
                      ("jax", ["jax"]), ("jaxlib.xla", ["jaxlib"]),
                      ("flax", ["flax"]), ("jaxtyping", [])):
        monkeypatch.setitem(sys.modules, name, m_qv)
        assert forbidden_modules() == bad, name
        monkeypatch.delitem(sys.modules, name)


def test_nothing_under_kbench_loads_jax(tiny):
    """A fresh interpreter that imports every module of the benchmark and
    runs a cell loads neither JAX nor the JAX package."""
    code = (
        "import sys, time, pkgutil, importlib; sys.path.insert(0, %r)\n"
        "import kbench\n"
        "for m in pkgutil.walk_packages(kbench.__path__, 'kbench.'):\n"
        "    if '.tests' not in m.name: importlib.import_module(m.name)\n"
        "from kbench import harness, run\n"
        "for c in ('sr-k31.count-b37', 'asm-k31.qv'):\n"
        "    harness.find_cell(%r, c)\n"
        "harness.run_cell(%r, 'asm-k31.qv', 1, 0.01, 1, 'cpu',"
        " time.perf_counter())\n"
        "print(run.forbidden_modules())\n" % (str(REPO), str(tiny),
                                             str(tiny)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _cli(cwd, *extra):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(cwd)}
    return subprocess.run(
        [sys.executable, "kbench/run.py", "--workload", "sr-k31.count-b37",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = _cli(REPO)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_command_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and kbench/."""
    shutil.copytree(REPO / "kbench", tmp_path / "kbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
    assert "yak_tpu_torch" in out.stderr
