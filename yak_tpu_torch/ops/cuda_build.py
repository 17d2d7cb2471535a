"""Build and load the port's hand-written CUDA kernels.

Each kernel source `yak_tpu_torch/csrc/<name>.cu` has a plain C
interface; it is compiled by `nvcc` for Hopper (sm_90a) into a shared
library under `build/yak_tpu_torch/` at the repository root, named by
the hash of the source and the flags, and loaded with ctypes.  A changed
source builds anew; an unchanged one loads the library already built.
Nothing is built when a module is imported: the first launch builds.
`load_all` builds several sources with one nvcc process each, side by
side (one thread each).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "yak_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED = {}    # library name -> (ctypes.CDLL, build seconds)


def nvcc_path():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def library_path(name):
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def load(name):
    """Return (ctypes.CDLL, seconds spent building in this process) for
    csrc/<name>.cu, building it first if needed."""
    if name in _LOADED:
        return _LOADED[name]
    out = library_path(name)
    secs = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.time()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               str(CSRC_DIR / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
        os.replace(tmp, out)
        secs = time.time() - t0
    _LOADED[name] = (ctypes.CDLL(str(out)), secs)
    return _LOADED[name]


def load_all(names):
    """load() for several sources, one thread each, so their nvcc
    processes run side by side.  Returns {name: (CDLL, seconds)}."""
    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(load, names)))
