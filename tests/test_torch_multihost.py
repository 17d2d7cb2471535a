"""Counting over several processes (`yak_tpu_torch.parallel.multihost`):
real worker processes (tests/torch_mh_worker.py) joined over `gloo` on a
loopback address, each driving CPU shards of one global mesh, must give
on every process `yak_tpu`'s one-process count and the dump of the
port's one-process mesh of as many shards, byte for byte.  The inputs
are tests/test_multihost.py's (rng 21, k=17, chunk 2^14), from 2^10
lanes a shard, so that every shard grows; 2 processes x 2 shards on the
default engine, the -b two-pass and the psort engine, and 4 processes x
1 shard."""

import contextlib
import hashlib
import io
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import util
from yak_tpu.models.count import CountOpts as JaxOpts
from yak_tpu.models.count import count_file as jax_count_file
from yak_tpu_torch import native
from yak_tpu_torch.models.count import CountOpts
from yak_tpu_torch.parallel import multihost
from yak_tpu_torch.parallel.mesh import (count_file_mesh, make_mesh,
                                         mesh_routed_groups)

WORKER = os.path.join(os.path.dirname(__file__), "torch_mh_worker.py")
TIMEOUT_S = 120          # a worker that fails or passes it fails the case
CPU = torch.device("cpu")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The reads; `yak_tpu`'s one-process items, sorted, all and with
    counts of 2 or more (the -b protocol's output); the md5s of the
    port's one-process dumps on [cpu] * 4, plain and -b20 (pass 1 gated,
    the filter dropped and the counts cleared, pass 2, the shrink)."""
    d = tmp_path_factory.mktemp("mh")
    rng = np.random.default_rng(21)
    genome = util.make_genome(rng, 20_000)
    reads = util.mutate_reads(rng, genome, 600, 120, err=0.005,
                              n_rate=0.002)
    fa = str(d / "reads.fa")
    util.to_fasta(fa, reads)
    native.build()        # here, so that no two workers build it at once
    h, c = jax_count_file(fa, JaxOpts(k=17, chunk_size=1 << 14,
                                      cap_log2=12)).items()
    o = np.argsort(h)
    out = {"fa": fa, "jax": (h[o], c[o])}
    keep = c[o] >= 2
    out["jax_b"] = (h[o][keep], c[o][keep])
    mesh = make_mesh(devices=[CPU] * 4)
    for bf_shift in (0, 20):
        opt = CountOpts(k=17, chunk_size=1 << 14, cap_log2=10, device="cpu",
                        bf_shift=bf_shift)
        table = count_file_mesh(fa, opt, mesh)
        if bf_shift:
            table.destroy_bf()
            table.clear_counts()
            count_file_mesh(fa, opt, mesh, table=table)
            table.shrink(2, 1023)
        path = d / f"one{bf_shift}.yak"
        with contextlib.redirect_stderr(io.StringIO()):
            table.dump(path)
        out[f"md5_{bf_shift}"] = _md5(path)
    return out


def _run_workers(nprocs, shards, fa, outdir, env_extra):
    """nprocs workers of `shards` CPU shards each; every one is killed
    when one fails or TIMEOUT_S passes, and the case then fails."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")   # tiny folds, many procs
    env.pop("YAK_TPU_PSORT", None)
    env.update(env_extra)
    logs = [open(outdir / f"log{i}.txt", "wb") for i in range(nprocs)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, coord, str(nprocs), str(i), str(shards),
         fa, str(outdir)], stdout=log, stderr=subprocess.STDOUT, env=env)
        for i, log in enumerate(logs)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while (any(p.poll() is None for p in procs)
               and not any(p.returncode for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    for i, p in enumerate(procs):
        text = (outdir / f"log{i}.txt").read_text(errors="replace")
        assert p.returncode == 0, f"worker {i}, rc {p.returncode}:\n" + \
            text[-3000:]


@pytest.mark.parametrize("nprocs,shards,bf_shift,psort", [
    (2, 2, 0, False), (2, 2, 20, False), (2, 2, 0, True), (4, 1, 0, False)],
    ids=["2x2", "2x2-bloom", "2x2-psort", "4x1"])
def test_processes_count_equals_one_process(data, tmp_path, nprocs, shards,
                                            bf_shift, psort):
    env = {"MH_BF_SHIFT": str(bf_shift)}
    if psort:
        env["YAK_TPU_PSORT"] = "1"
    _run_workers(nprocs, shards, data["fa"], tmp_path, env)
    jh, jc = data["jax_b" if bf_shift else "jax"]
    for pid in range(nprocs):
        got = np.load(tmp_path / f"items{pid}.npz")
        # growth really ran on this process's shards and on the whole mesh
        assert int(got["local_cap"]) > 1 << 10
        assert int(got["cap"]) >= int(got["local_cap"])
        assert int(got["routed"]) == 2      # 4 chunks, then 1
        o = np.argsort(got["h"])
        np.testing.assert_array_equal(got["h"][o], jh)
        np.testing.assert_array_equal(got["c"][o], jc)
        assert _md5(tmp_path / f"dump{pid}.yak") == data[f"md5_{bf_shift}"]


def test_refusals(data):
    """One process over gloo: a mesh of L x P shards that is not a power
    of two, -X, the lookups; without a card, the default (CUDA) mesh."""
    multihost.init_multihost(f"127.0.0.1:{_free_port()}", 1, 0,
                             backend="gloo")
    try:
        with pytest.raises(ValueError, match="power of two"):
            multihost.global_mesh([CPU] * 3)
        mesh = multihost.global_mesh([CPU] * 2)
        opt = CountOpts(k=17, chunk_size=1 << 14, device="cpu",
                        bf_shift=20, exact=True)
        with pytest.raises(ValueError, match="-X"):
            multihost.count_file_multihost(data["fa"], opt, mesh)
        table = multihost.count_file_multihost(
            data["fa"], CountOpts(k=17, chunk_size=1 << 14, device="cpu"),
            mesh)
        with pytest.raises(NotImplementedError, match="several processes"):
            next(mesh_routed_groups(data["fa"], table, 1 << 14))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                multihost.global_mesh()
    finally:
        dist.destroy_process_group()
