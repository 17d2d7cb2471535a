"""Times the compaction kernel (yak_tpu_torch/csrc/compact.cu) with and
without its sparse-tile branch, on one CUDA card.

A tile that keeps at most SPARSE lanes reads klo and v while it stages
its kept lanes, before it waits for the earlier tiles' offset; a denser
tile reads them as it writes its run.  This script builds the source as
it stands ("split") and a copy with SPARSE = 0 ("no split": every tile
that keeps a lane takes the dense branch), checks both against
ops/compact.compact_plain, and times both, device only, at three
synthetic inputs: the -b24 sentinel post's shape (67,632,913 lanes,
524,289 kept, klo = khi), chkerr's (8,388,578 lanes, 22,996 kept,
klo = khi) and a dense one (8,388,578 lanes, half kept).  The kept
lanes lie at random, from a fixed seed.

Run from the repository root:

    python3 tools/compact_sparse_probe.py

It prints the card's name and power limit, one line an input, and last
one JSON object of the times (ms a call; two blocks of 20 calls each,
run as split, no split, no split, split).
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from yak_tpu_torch.ops import compact, cuda_build  # noqa: E402

SHAPES = {   # name: (lanes, kept lanes or a keep density, klo = khi)
    "sentinel_post": (67_632_913, 524_289, True),
    "chkerr": (8_388_578, 22_996, True),
    "dense": (8_388_578, 0.5, False),
}
REPS = 20


def bind(lib):
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.yak_compact.argtypes = [p, p, p, i64, p, p, p, p, p, i32]
    lib.yak_compact.restype = i32
    lib.yak_compact_scratch_words.argtypes = [p, i64]
    lib.yak_compact_scratch_words.restype = i64
    return lib


def build_no_split():
    """csrc/compact.cu with SPARSE = 0, built as cuda_build builds it."""
    src = (cuda_build.CSRC_DIR / "compact.cu").read_text()
    line = "constexpr int SPARSE = TILE / 16;"
    if src.count(line) != 1:
        raise RuntimeError(f"compact.cu no longer holds `{line}`")
    out_dir = cuda_build.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "compact_nosplit.cu"
    cu.write_text(src.replace(line, "constexpr int SPARSE = 0;"))
    so = out_dir / "libcompact_nosplit.so"
    res = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                          "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    return ctypes.CDLL(str(so))


def launch(lib, khi, klo, v):
    """ops/compact._launch through `lib`."""
    n, dev = khi.numel(), khi.device
    scratch = torch.empty(lib.yak_compact_scratch_words(khi.data_ptr(), n),
                          dtype=torch.int64, device=dev)
    outs = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(3)]
    err = lib.yak_compact(khi.data_ptr(), klo.data_ptr(), v.data_ptr(), n,
                          scratch.data_ptr(), *(o.data_ptr() for o in outs),
                          torch.cuda.current_stream(dev).cuda_stream,
                          dev.index)
    if err != 0:
        raise RuntimeError(f"compact launch failed: CUDA error {err}")
    return (*outs, scratch.view(torch.int32)[1])


def planes(n, kept, alias, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    if isinstance(kept, float):
        keep = torch.rand(n, generator=g, device=dev) < kept
    else:
        keep = torch.zeros(n, dtype=torch.bool, device=dev)
        keep[torch.randperm(n, generator=g, device=dev)[:kept]] = True
    val = torch.randint(0, 1 << 31, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    khi = torch.where(keep, val, torch.iinfo(torch.int32).min)
    v = torch.randint(-5, 1024, (n,), generator=g, device=dev,
                      dtype=torch.int32)
    klo = khi if alias else torch.randint(
        -(1 << 31), 1 << 31, (n,), generator=g, device=dev, dtype=torch.int32)
    return khi, klo, v


def device_ms(fn):
    """ms a call, device only: the stream is held busy while REPS calls
    are queued, so the events bracket the device work alone."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / REPS


def main():
    if not torch.cuda.is_available():
        sys.exit("compact_sparse_probe: needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card)
    libs = {"split": bind(cuda_build.load("compact")[0]),
            "no_split": bind(build_no_split())}
    result = {"card": card, "reps": REPS, "shapes": {}}
    for i, (name, (n, kept, alias)) in enumerate(SHAPES.items()):
        args = planes(n, kept, alias, 100 + i, dev)
        want = compact.compact_plain(*args)
        m = int(want[3])
        for which, lib in libs.items():
            got = launch(lib, *args)
            if int(got[3]) != m or not all(
                    torch.equal(g[:m], w[:m])
                    for g, w in zip(got[:3], want[:3])):
                raise AssertionError(f"{which} != plain at {name}")
        t = {k: [] for k in libs}
        for which in ("split", "no_split", "no_split", "split"):
            t[which].append(device_ms(lambda: launch(libs[which], *args)))
        result["shapes"][name] = {"n": n, "kept": m, "klo_is_khi": alias,
                                  **{f"{k}_ms": v for k, v in t.items()}}
        print(f"{name}: n {n}, kept {m}; device ms split "
              f"{t['split']}, no split {t['no_split']} [{card}]")
    print(json.dumps(result))


if __name__ == "__main__":
    main()
