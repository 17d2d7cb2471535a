"""The chkerr slice on the CPU: the port's run-marker mid and marker
compaction (ops/countstep.chkerr_mark_mid, run_mark_compact) against the
JAX package's (get_chkerr_mark_mid, run_mark_compact with the Pallas
compaction kernel in interpret mode), and `chkerr`'s stdout
byte-identical to `yak_tpu`'s for reads and contigs at the smallest
chunk, with runs that cross a chunk edge, through the marker-budget
overflow and through the CLI.  Every value is an integer: all
comparisons are exact."""

import contextlib
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_lookup_cases import CHUNK, write_contigs, write_reads
from yak_tpu import cli as jax_cli
from yak_tpu.models import chkerr as jch
from yak_tpu.models import count as jcount
from yak_tpu.ops import countstep as jcs
from yak_tpu.table import KmerTable as JaxTable
from yak_tpu_torch.models import chkerr as pch
from yak_tpu_torch.ops import countstep as pcs
from yak_tpu_torch.table import KmerTable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The FASTQ, the FASTA and the `.yak` table that `yak_tpu` counts
    from the FASTQ."""
    d = tmp_path_factory.mktemp("chkerr_inputs")
    fq, fa, yak = str(d / "reads.fq"), str(d / "contigs.fa"), str(d / "t.yak")
    write_reads(fq)
    write_contigs(fa)
    jcount.count_file(fq, jcount.CountOpts(k=31, chunk_size=CHUNK)).dump(yak)
    return {"fastq": fq, "fasta": fa, "yak": yak}


def _chkerr_text(mod, table, path, **opts):
    buf = io.StringIO()
    mod.main_chkerr(mod.ChkerrOpts(chunk_size=CHUNK, **opts), table, path,
                    out=buf)
    return buf.getvalue()


def _both(inputs, kind, **opts):
    want = _chkerr_text(jch, JaxTable.restore(inputs["yak"]), inputs[kind],
                        **opts)
    got = _chkerr_text(pch, KmerTable.restore(inputs["yak"], "cpu"),
                       inputs[kind], **opts)
    return got, want


@pytest.mark.parametrize("min_cnt", [1, 3])
def test_mark_mid_and_compaction_match_jax(min_cnt):
    """Seeded lane values through both mids (the JAX one fed a key-order
    value stream and its index payload) and both marker compactions."""
    rng = np.random.default_rng(31 + min_cnt)
    M = 20000
    vals = rng.integers(-1, 8, M).astype(np.int32)
    vals[rng.random(M) < 0.5] = 30
    vals[:40] = -1                        # a run from lane 0
    vals[-25:] = 0                        # a run to the last lane
    valid = rng.random(M) < 0.95
    perm = rng.permutation(M).astype(np.int32)
    jkhi, jrun, jn = jcs.get_chkerr_mark_mid(31, min_cnt, M)(
        jnp.asarray(vals[perm]), jnp.asarray(perm[::-1].copy()),
        jnp.asarray(valid))
    pkhi, prun, pn = pcs.chkerr_mark_mid(torch.from_numpy(vals),
                                         torch.from_numpy(valid), min_cnt, M)
    n = int(pn)
    assert n == int(jn) and n > 100
    np.testing.assert_array_equal(pkhi.numpy(),
                                  np.asarray(jkhi).view(np.int32))
    np.testing.assert_array_equal(prun.numpy(), np.asarray(jrun))
    maxr = jcs.CHKERR_MAX_RUNS
    jl, jp = jcs.run_mark_compact(jkhi, jrun, maxr, interpret=True)
    pl, pp = pcs.run_mark_compact(pkhi, prun)
    assert pl.shape == pp.shape == (M,)
    np.testing.assert_array_equal(pl.numpy()[:n],
                                  np.asarray(jl)[:n].astype(np.int32))
    np.testing.assert_array_equal(pp.numpy()[:n], np.asarray(jp)[:n])


@pytest.mark.parametrize("kind,opts", [
    ("fastq", {}),
    ("fasta", {}),
    ("fasta", {"min_cnt": 2, "min_streak": 3}),
])
def test_main_chkerr_stdout_matches_jax(inputs, kind, opts):
    got, want = _both(inputs, kind, **opts)
    assert got == want
    rows = [line.split("\t") for line in got.splitlines()]
    assert len(rows) > 20
    if kind == "fasta":
        # the novel stretch of ctg0 crosses the first chunk edge
        assert any(r[0] == "ctg0" and int(r[1]) < CHUNK < int(r[2])
                   and int(r[3]) > 2000 for r in rows)


def test_marker_budget_overflow_matches_jax(inputs, monkeypatch):
    """Past the marker budget the JAX package takes the low runs from the
    chunk's per-lane values and the port copies every marker of its
    compacted planes; the text is the same."""
    monkeypatch.setattr(jcs, "CHKERR_MAX_RUNS", 4)
    monkeypatch.setattr(pcs, "CHKERR_MAX_RUNS", 4)
    jcs.get_chkerr_step.cache_clear()
    try:
        got, want = _both(inputs, "fastq")
    finally:
        jcs.get_chkerr_step.cache_clear()
    assert got == want and got.count("\n") > 20


def test_cli_matches_jax(inputs):
    args = ["chkerr", f"-K{CHUNK}", "-c", "3", "-s", "4", inputs["yak"],
            inputs["fasta"]]
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "yak_tpu_torch",
                          "--device", "cpu", *args],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[M::main] CMD: yak_tpu_torch chkerr" in res.stderr
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jax_cli.main(args) == 0
    assert res.stdout == buf.getvalue()
