"""sexchr and groupxy on the CPU: `countstep.sexchr_reduce` against the
JAX package's `get_sexchr_join_post`, the SEXCHR load modes through
restore-into against `load_sexchr_tables`, and the stdout of `sexchr`
(at the smallest chunk, so that contigs span chunks) and of `groupxy`
on it byte-identical to `yak_tpu`'s, for k = 21 and k = 33 tables, on
both of the port's engines and through the CLI.  The inputs are the
chrY / chrX / PAR stretches and the two haplotypes of
tests/torch_algebra_cases.py.  Exact comparisons."""

import contextlib
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_algebra_cases as cases
from yak_tpu import cli as jax_cli
from yak_tpu.models import sexchr as jsex
from yak_tpu.ops import countstep as jcs
from yak_tpu_torch.models import count as pcount
from yak_tpu_torch.models import scan as pscan
from yak_tpu_torch.models import sexchr as psex
from yak_tpu_torch.ops import countstep as pcs
from yak_tpu_torch.ops import sort

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sexchr_reduce_matches_jax():
    """Flags 0-7 and absent lanes in runs, some invalid lanes, segment
    bounds with an empty segment, one past M and the padding at M; the
    JAX post reads the JOIN's values in a permuted order."""
    M, ns = 20000, 4096
    rng = np.random.default_rng(12)
    runs = rng.geometric(1 / 30, M)
    vals = np.repeat(rng.choice(np.array([-1, 0, 1, 2, 3, 4, 5, 6, 7],
                                         np.int32), len(runs)), runs)[:M]
    valid = rng.random(M) < 0.97
    starts = np.sort(rng.choice(np.arange(1, M), 60, replace=False))
    bounds = np.full(ns + 1, M, np.int32)
    bounds[:63] = np.minimum(np.concatenate([[0], starts, [starts[5], M + 9]]),
                             M)
    bounds[:63].sort()
    perm = rng.permutation(M)
    want = jcs.get_sexchr_join_post(21, ns, M)(
        jnp.asarray(vals[perm]), jnp.asarray(perm[::-1].astype(np.int32)),
        jnp.asarray(valid), jnp.asarray(bounds))
    got = pcs.sexchr_reduce(torch.from_numpy(vals), torch.from_numpy(valid),
                            torch.from_numpy(bounds), M)
    assert got.dtype == torch.int32 and got.shape == (4 * ns,)
    got = got.numpy().reshape(4, ns)
    for j in range(4):
        np.testing.assert_array_equal(got[j], np.asarray(want[j]))
    assert got[3].sum() > 1000 and (got[0][:62] == 0).any()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The seeded inputs, and the chrY / chrX / PAR tables at k = 21 and
    33."""
    d = tmp_path_factory.mktemp("sexchr_inputs")
    paths = cases.write_inputs(str(d))
    for k in (21, 33):
        for name in ("chrY", "chrX", "PAR"):
            paths[name, k] = str(d / f"{name}{k}.yak")
            pcount.count_file(paths[name], pcount.CountOpts(
                k=k, chunk_size=cases.CHUNK, device="cpu")).dump(
                    paths[name, k])
    return paths


def _yaks(inputs, k):
    return [inputs[name, k] for name in ("chrY", "chrX", "PAR")]


@pytest.mark.parametrize("k", [21, 33])
def test_load_sexchr_tables_matches_jax(inputs, k):
    """Presence bits 1, 2 and 4 ORed into one table; the PAR stretch
    shares k-mers with neither, chrY's and chrX's none with each other
    but a few by chance."""
    jh, jc = jsex.load_sexchr_tables(*_yaks(inputs, k)).items()
    ph, pc = psex.load_sexchr_tables(*_yaks(inputs, k), "cpu").items()
    np.testing.assert_array_equal(ph, jh)
    np.testing.assert_array_equal(pc, jc)
    assert set(np.unique(pc)) >= {1, 2, 4}


_JAX = {}


def _sexchr(mod, table, inputs, chunk):
    buf = io.StringIO()
    mod.main_sexchr(mod.SexchrOpts(chunk_size=chunk), table,
                    [inputs["hap1"], inputs["hap2"]], out=buf)
    return buf.getvalue()


@pytest.mark.parametrize("psort", [False, True])
@pytest.mark.parametrize("k,chunk", [(21, cases.CHUNK), (33, cases.CHUNK)])
def test_main_sexchr_and_groupxy_match_jax(inputs, monkeypatch, psort, k,
                                           chunk):
    """sexchr's stdout (at the smallest chunk, contigs span chunks) and
    groupxy's lines on it at two threshold sets; under psort each
    chunk's query sort goes through ops/sort.sort."""
    monkeypatch.delenv("YAK_TPU_PSORT", raising=False)
    key = (k, chunk)
    if key not in _JAX:
        _JAX[key] = _sexchr(jsex, jsex.load_sexchr_tables(*_yaks(inputs, k)),
                            inputs, chunk)
    want = _JAX[key]
    if psort:
        monkeypatch.setenv("YAK_TPU_PSORT", "1")
    calls = []
    real = sort.sort
    monkeypatch.setattr(sort, "sort",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    pieces = []
    real_fold = pscan._fold_seg_sums

    def spy(stream):
        def watch():
            for packed, r in stream:
                pieces.append(len(packed.rec_gid))
                yield packed, r
        return real_fold(watch())

    monkeypatch.setattr(pscan, "_fold_seg_sums", spy)
    got = _sexchr(psex, psex.load_sexchr_tables(*_yaks(inputs, k), "cpu"),
                  inputs, chunk)
    assert got == want
    assert got.startswith(psex.SEXCHR_HEADER) and got.count("\nS\t") == 18
    assert (len(calls) == len(pieces)) if psort else not calls
    if chunk == cases.CHUNK:     # contigs in pieces across chunks
        assert len(pieces) >= 6 and sum(pieces) > 18
    rows = got.splitlines()
    assert any(r.split("\t")[6] != "0" for r in rows[2:])
    assert any(r.split("\t")[7] != "0" for r in rows[2:])
    for thres in ((0.7, 0.3, 0.9), (0.5, 0.1, 0.6)):
        lines = psex.groupxy(io.StringIO(got), *thres)
        assert lines == jsex.groupxy(io.StringIO(want), *thres)
        assert {r.split("\t")[3] for r in lines} == {"1", "2"}


def test_cli_matches_jax(inputs, tmp_path):
    """sexchr -K 16384 then groupxy -s .6 on its output through `python
    -m yak_tpu_torch`: the JAX package's stdout, and the port's
    footer."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    outs = {}
    for name, argv in (("sexchr", ["sexchr", f"-K{cases.CHUNK}",
                                   *_yaks(inputs, 21), inputs["hap1"],
                                   inputs["hap2"]]),
                       ("groupxy", ["groupxy", "-s", ".6",
                                    str(tmp_path / "sexchr.txt")])):
        res = subprocess.run([sys.executable, "-m", "yak_tpu_torch",
                              "--device", "cpu", *argv],
                             cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        assert f"[M::main] CMD: yak_tpu_torch {name}" in res.stderr
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            assert jax_cli.main(argv) == 0
        assert res.stdout == buf.getvalue()
        outs[name] = res.stdout
        (tmp_path / "sexchr.txt").write_text(res.stdout)
    assert outs["groupxy"].count("\n") == 18
