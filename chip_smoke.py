"""On-card smoke check of the PyTorch/CUDA port (`yak_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. the card's name and power limit (nvidia-smi), torch and CUDA
     versions;
  2. build the hand-written merge-reduce kernel (csrc/merge_reduce.cu)
     with nvcc into build/yak_tpu_torch/;
  3. kernel vs its plain torch version on the card: the merge cases of
     tests/torch_merge_cases.py, and the inputs of every fold of one
     count of the phase 4 workload (captured as the count path passes
     them to the wrapper, so at its exact shapes; this count is also
     phase 4's warm-up); keys, counts, size, n_new and the overflow flag
     must be equal, and both are timed with CUDA events on each fold;
  4. the count path at real size: bench.py's count workload (seed 42,
     2 Mbp genome, 400,000 x 150 bp reads, 0.3% errors) counted by
     KmerTable(31, cap_log2=23, flush_lanes=4*4194281, device="cuda");
     the distinct total and the histogram digest must equal the JAX
     package's gates (6226713, 669014fae5d3), and the kernel must have
     launched; prints the rate and a per-fold split on the device
     timeline (CUDA events) and on the host clock; then the same count
     from a 2^21-lane table must grow (overflow replay) and pass the
     same gates;
  5. the CLI on the card and on the CPU must dump byte-identical .yak
     files for a FASTQ and a FASTA with N runs.

The last two lines of stdout are a JSON line of per-kernel results and
the contract line {"ok": true, "device": {...}}.  Imports no JAX.
"""

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
TOTAL_GATE = 6226713                 # bench.py:673
HIST_GATE = "669014fae5d3"           # bench.py:248
K = 31
READ_LEN = 150
N_READS = 400_000
GENOME_LEN = 2_000_000
ERR = 0.003
CHUNK_READS = 27_776                 # chunk = CHUNK_READS * 151 bases
KERNEL = {"name": "merge_reduce", "route": "cuda",
          "source": "yak_tpu_torch/csrc/merge_reduce.cu",
          "replaces": "yak_tpu/ops/pallas_merge.py:155"}


def log(msg):
    print(msg, flush=True)


def phase(name):
    torch.cuda.synchronize()
    log(f"== {name}")


# -- phase 1 ------------------------------------------------------------

def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


# -- phase 3 ------------------------------------------------------------

def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def compare(merge, args, create, label):
    """Kernel vs plain on one input; returns the max abs difference
    (0 when equal) after asserting equality."""
    tkeys, tcnt, size, bkeys = args
    ok, oc, ns, nn = merge.merge_reduce(tkeys, tcnt, size, bkeys, create)
    pk, pc, ps, pn = merge.merge_reduce_plain(tkeys, tcnt, size, bkeys,
                                              create)
    torch.cuda.synchronize()
    cap = tkeys.numel()
    live = min(int(ps), cap)
    err = max(int((ok[:live] - pk[:live]).abs().max()) if live else 0,
              int((oc[:live] - pc[:live]).abs().max()) if live else 0,
              abs(int(ns) - int(ps)), abs(int(nn) - int(pn)))
    if (err or (int(ns) > cap) != (int(ps) > cap)):
        raise AssertionError(
            f"{label}: kernel != plain (size {int(ns)} vs {int(ps)}, "
            f"n_new {int(nn)} vs {int(pn)}, max abs err {err})")
    log(f"  {label}: equal (size {int(ns)}, n_new {int(nn)}, "
        f"overflow {int(ns) > cap})")
    return err


class _CaptureMerge:
    """Stands in for the ops.merge module inside ops.countstep for one
    count: records each fold's merge-reduce arguments and forwards the
    call to the real wrapper."""

    def __init__(self, merge):
        self.merge, self.calls = merge, []

    def merge_reduce(self, *args):
        self.calls.append(args)
        return self.merge.merge_reduce(*args)


def fold_inputs(chunks, dev):
    """The merge-reduce arguments of every fold of one count of `chunks`
    (tkeys, tcnt, size, bkeys, create).  A fold never writes into its
    inputs, so they stay valid after the count."""
    from yak_tpu_torch.ops import countstep, merge

    spy = _CaptureMerge(merge)
    countstep.merge = spy
    try:
        run_count(chunks, dev)
    finally:
        countstep.merge = merge
    return spy.calls


def kernel_checks(dev, chunks):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_merge_cases import CASES, expected, sorted_table
    from yak_tpu_torch.ops import merge
    from yak_tpu_torch.ops.countstep import sort_batch
    from yak_tpu_torch.ops.keys import torch_to_u64, u64_to_torch

    err = 0
    for name, (build, _pallas) in CASES.items():
        hs, cs, batch, valid, cap, create = build()
        tk, tc = sorted_table(hs, cs, cap)
        tkeys = u64_to_torch(tk, dev)
        tcnt = torch.from_numpy(tc).to(dev)
        size = torch.tensor(len(hs), dtype=torch.int32, device=dev)
        bkeys = sort_batch(u64_to_torch(batch, dev),
                           torch.from_numpy(valid).to(dev))
        err = max(err, compare(merge, (tkeys, tcnt, size, bkeys), create,
                               name))
        # and against the contract in plain numpy
        ok, oc, ns, nn = merge.merge_reduce(tkeys, tcnt, size, bkeys,
                                            create)
        wk, wc, wsize, wnew = expected(hs, cs, batch, valid, cap, create)
        got_k = torch_to_u64(ok)[:len(wk)]
        got_c = oc.cpu().numpy()[:len(wc)]
        if not (int(ns) == wsize and int(nn) == wnew
                and np.array_equal(got_k, wk) and np.array_equal(got_c, wc)):
            raise AssertionError(f"{name}: kernel != numpy contract")

    folds = fold_inputs(chunks, dev)
    if not folds:
        raise AssertionError("the count path made no merge-reduce call")
    times = []
    for i, args in enumerate(folds):
        tkeys, tcnt, size, bkeys, create = args
        label = (f"count fold {i} (cap {tkeys.numel()}, live {int(size)}, "
                 f"B {bkeys.numel()})")
        err = max(err, compare(merge, args[:4], create, label))
        ms = time_ms(lambda: merge.merge_reduce(*args), 20)
        plain_ms = time_ms(lambda: merge.merge_reduce_plain(*args), 5)
        log(f"  {label}: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms")
        times.append((ms, plain_ms))
    # the increment-only mode on the last fold's real inputs
    err = max(err, compare(merge, folds[-1][:4], False,
                           f"count fold {len(folds) - 1}, create=False"))
    ms = sum(t[0] for t in times) / len(times)
    plain_ms = sum(t[1] for t in times) / len(times)
    log(f"  mean over the {len(folds)} folds: kernel {ms:.4f} ms, plain "
        f"torch {plain_ms:.4f} ms")
    return err, ms, plain_ms


# -- phase 4 ------------------------------------------------------------

def make_reads():
    """bench.py:71-82, regenerated here."""
    rng = np.random.default_rng(42)
    genome = rng.integers(0, 4, GENOME_LEN, dtype=np.uint8)
    starts = rng.integers(0, GENOME_LEN - READ_LEN + 1, N_READS)
    reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    m = rng.random(reads.shape) < ERR
    reads = np.where(m, (reads + rng.integers(1, 4, reads.shape)) % 4,
                     reads).astype(np.uint8)
    rc = rng.random(N_READS) < 0.5
    reads = np.where(rc[:, None], (3 - reads)[:, ::-1], reads)
    return reads


def pack_chunks(reads):
    """bench.py:85-98: one separator column, flat chunks aligned on read
    boundaries."""
    n = len(reads)
    flat = np.concatenate(
        [reads, np.full((n, 1), 4, np.uint8)], axis=1).reshape(-1)
    per = CHUNK_READS * (READ_LEN + 1)
    chunks = []
    for off in range(0, len(flat), per):
        c = flat[off:off + per]
        if len(c) < per:
            c = np.concatenate([c, np.full(per - len(c), 4, np.uint8)])
        chunks.append(c)
    return chunks


def run_count(chunks, dev, marks=None, cap_log2=23):
    """Count `chunks` into a new table on `dev`.  With `marks` (a list),
    appends (name, CUDA event or None, host perf_counter) at each chunk's
    insert ("insert"), at each fold phase as it is queued (the table's
    phase names), before the final flush ("flush") and after the last
    synchronize ("end")."""
    from yak_tpu_torch.table import KmerTable

    table = KmerTable(K, cap_log2=cap_log2, flush_lanes=4 * 4194281,
                      cap_hinted=True, device=dev)

    def host_mark(name):
        if marks is not None:
            marks.append((name, None, time.perf_counter()))

    def hook(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    if marks is not None:
        table.phase_hook = hook
    for c in chunks:
        host_mark("insert")
        table.insert_codes(c)
    host_mark("flush")
    table.flush()
    torch.cuda.synchronize()
    host_mark("end")
    return table


def split_marks(marks, card):
    """Print the per-fold split of one marked count: device spans from
    CUDA events, host spans from perf_counter, and the host time of the
    chunk packing (each "insert" up to the next mark)."""
    pack_s = sum(b[2] - a[2] for a, b in zip(marks, marks[1:])
                 if a[0] == "insert")
    folds, cur = [], None
    for m in marks:
        if m[0] == "start":
            cur = [m]
            folds.append(cur)
        elif cur is not None and m[1] is not None:
            cur.append(m)
    busy_ms = 0.0
    for i, f in enumerate(folds):
        dev_spans = [(b[0], a[1].elapsed_time(b[1])) for a, b in zip(f, f[1:])]
        host_spans = [(b[0], (b[2] - a[2]) * 1e3) for a, b in zip(f, f[1:])]
        busy_ms += sum(ms for name, ms in dev_spans if name != "h2d")
        log(f"  fold {i} device: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in dev_spans) + f" [{card}]")
        log(f"  fold {i} host:   " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in host_spans))
    wall_s = marks[-1][2] - marks[0][2]
    log(f"  host chunk packing (detect_periodic + pack_planes2) inside the "
        f"count: {pack_s:.4f} s of {wall_s:.4f} s wall")
    log(f"  device compute (extract+sort+merge+finalize) {busy_ms:.4f} ms "
        f"of {wall_s * 1e3:.4f} ms wall [{card}]")


def count_path(dev, card, chunks):
    from yak_tpu_torch.ops import merge

    n_kmers = N_READS * (READ_LEN - K + 1)
    log(f"  {len(chunks)} chunks of {chunks[0].shape[0]} bases, "
        f"{n_kmers} k-mer instances (warmed up by phase 3's count)")

    marks = []
    merge.merge_reduce.launches = 0
    t0 = time.perf_counter()
    table = run_count(chunks, dev, marks)
    wall = time.perf_counter() - t0
    launches = merge.merge_reduce.launches

    check_gates(table, f"kernel launches {launches}")
    if launches <= 0:
        raise AssertionError("the count path never launched the kernel")
    log(f"  count wall {wall:.4f} s, {n_kmers / wall:.1f} k-mers/s "
        f"[{card}]")
    split_marks(marks, card)

    # the same host work alone, after the count
    from yak_tpu_torch.io.pack import detect_periodic, pack_planes2

    t0 = time.perf_counter()
    for c in chunks:
        detect_periodic(c)
        pack_planes2(c)
    log(f"  host detect_periodic + pack_planes2 alone: "
        f"{time.perf_counter() - t0:.4f} s for {len(chunks)} chunks")

    # table growth on the card: from 2^21 lanes the folds overflow, are
    # caught one fold late and replay at 2^22, then 2^23
    t0 = time.perf_counter()
    grown = run_count(chunks, dev, cap_log2=21)
    secs = time.perf_counter() - t0
    check_gates(grown, f"grown from cap 2^21 to {grown.cap} lanes in "
                       f"{secs:.4f} s")
    if grown.cap <= 1 << 21:
        raise AssertionError("the growth run never grew the table")
    return launches


def check_gates(table, note):
    tot = table.tot
    hd = hashlib.md5(np.ascontiguousarray(table.hist(), np.int64)
                     .tobytes()).hexdigest()[:12]
    log(f"  distinct {tot}, hist digest {hd}, {note}")
    if tot != TOTAL_GATE:
        raise AssertionError(f"wrong distinct count {tot} != {TOTAL_GATE}")
    if hd != HIST_GATE:
        raise AssertionError(f"wrong histogram digest {hd} != {HIST_GATE}")


# -- phase 5 ------------------------------------------------------------

def write_inputs(d):
    rng = np.random.default_rng(5)
    alph = np.frombuffer(b"ACGT", np.uint8)
    g = rng.integers(0, 4, 20_000)
    fq = os.path.join(d, "reads.fq")
    with open(fq, "wb") as f:
        for i in range(3000):
            s = rng.integers(0, len(g) - 120)
            r = g[s:s + 120]
            if rng.random() < 0.5:
                r = (3 - r)[::-1]
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, alph[r].tobytes(), b"I" * 120))
    fa = os.path.join(d, "contigs.fa")
    with open(fa, "wb") as f:
        for i in range(300):
            n = int(rng.integers(10, 700))
            s = rng.integers(0, len(g) - n)
            seq = alph[g[s:s + n]].copy()
            seq[rng.integers(0, n, max(1, n // 100))] = ord("N")
            f.write(b">c%d\n" % i)
            b = seq.tobytes()
            for j in range(0, len(b), 60):
                f.write(b[j:j + 60] + b"\n")
    return fq, fa


def cli_check():
    env = dict(os.environ, PYTHONPATH=ROOT)
    d = tempfile.mkdtemp(prefix="yak_tpu_torch_smoke_")
    try:
        for src in write_inputs(d):
            outs = {}
            for devname in ("cuda", "cpu"):
                out = os.path.join(d, f"out_{devname}.yak")
                cmd = [sys.executable, "-m", "yak_tpu_torch", "count",
                       "-k31", "-K", "200k", "--device", devname, "-o", out,
                       src]
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     env=env, cwd=ROOT, timeout=300)
                if res.returncode != 0:
                    raise AssertionError(f"CLI failed on {devname}: "
                                         f"{res.stderr[-2000:]}")
                with open(out, "rb") as f:
                    outs[devname] = f.read()
            if outs["cuda"] != outs["cpu"]:
                raise AssertionError(f"{os.path.basename(src)}: CUDA and "
                                     f"CPU dumps differ")
            log(f"  {os.path.basename(src)}: CUDA and CPU dumps identical "
                f"({len(outs['cuda'])} bytes, md5 "
                f"{hashlib.md5(outs['cuda']).hexdigest()[:12]})")
    finally:
        for name in os.listdir(d):
            os.unlink(os.path.join(d, name))
        os.rmdir(d)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from yak_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    phase("1. card")
    card = card_line()
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"device(s)")

    phase("2. build")
    _lib, secs = cuda_build.load("merge_reduce")
    log(f"  built {cuda_build.library_path('merge_reduce').name} in "
        f"{secs:.3f} s")

    chunks = pack_chunks(make_reads())

    phase("3. kernel vs plain torch on the card")
    err, ms, plain_ms = kernel_checks(dev, chunks)
    log(f"  [{card}]")

    phase("4. count path at real size")
    launches = count_path(dev, card, chunks)

    phase("5. CLI on the card vs on the CPU")
    cli_check()
    torch.cuda.synchronize()

    print(json.dumps({"kernels": [dict(KERNEL, launches=launches,
                                       max_abs_err=err, ms=ms,
                                       plain_ms=plain_ms)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
