"""Shared fixtures of the benchmark's own tests: a copy of the benchmark
under a temporary root with its configurations and mixes cut to a size
the CPU runs in seconds (the same names, so the harness finds them as
it finds the real ones), and the `card` marker for tests that need a
CUDA card, which decide inside the test whether one is there."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY_CFG = {"genome_bp": 20000, "coverage": 30}
# QV20 contigs: at this size the control's fingerprint lookups need
# absent k-mers to match falsely (qv's control, control.py)
TINY_ASM = {"contig_min_bp": 1500, "contig_max_bp": 6000, "sub_rate": 1e-2}
TINY_CHUNK = 1 << 16
TINY_MIX = {"count-b37": {"bf_shift": 20, "chunk_size": TINY_CHUNK},
            "qv": {"min_len": 3000, "chunk_size": TINY_CHUNK}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips inside the test "
                   "without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: run `python -m pytest kbench/tests "
                    "-m card` on the chip")
    return "cuda:0"


def tiny_root(tmp_path):
    """A benchmark root at tmp_path/bench: BENCHMARK.json and kbench/
    copied, the configurations and mixes cut to CPU size."""
    root = tmp_path / "bench"
    shutil.copytree(REPO / "kbench", root / "kbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for f in (root / "kbench" / "configs").glob("*.json"):
        cfg = json.loads(f.read_text())
        cfg.update(TINY_CFG)
        if "assembly" in cfg:
            cfg["assembly"].update(TINY_ASM)
        if "table" in cfg:
            cfg["table"].update(bf_shift=20, chunk_size=TINY_CHUNK)
        f.write_text(json.dumps(cfg))
    for name, over in TINY_MIX.items():
        f = root / "kbench" / "traffic" / f"{name}.json"
        f.write_text(json.dumps({**json.loads(f.read_text()), **over}))
    return root


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)
