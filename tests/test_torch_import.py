"""The port imports no JAX: every module of yak_tpu_torch imports in a
fresh interpreter without pulling jax (or yak_tpu, whose __init__
imports jax) into sys.modules.  A subprocess, because this test process
already imported jax (tests/conftest.py)."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import yak_tpu_torch, yak_tpu_torch.cli, yak_tpu_torch.table
names = [m.name for m in pkgutil.walk_packages(yak_tpu_torch.__path__,
                                               "yak_tpu_torch.")
         if m.name != "yak_tpu_torch.__main__"]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "yak_tpu.")))
bad += ["yak_tpu"] if "yak_tpu" in sys.modules else []
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 15, res.stdout
