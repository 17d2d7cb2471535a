"""inspect on the CPU: `open_yak_stream` against the JAX package's, and
the stdout of one-table and two-table `inspect` byte-identical to
`yak_tpu`'s on the seeded reads' tables of tests/torch_algebra_cases.py,
with batches small enough for several and a partial last one, at
k = 21 and k = 33, on both of the port's engines, and through the CLI.
Exact comparisons."""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_algebra_cases as cases
from yak_tpu.io import yakfmt as jfmt
from yak_tpu.models import inspect as jinspect
from yak_tpu_torch.io import yakfmt as pfmt
from yak_tpu_torch.models import count as pcount
from yak_tpu_torch.models import inspect as pinspect
from yak_tpu_torch.ops import countstep, sort

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """The two read sets' tables at k = 21 and 33."""
    d = tmp_path_factory.mktemp("inspect_inputs")
    paths = cases.write_inputs(str(d))
    out = {}
    for k in (21, 33):
        for name in ("reads_a", "reads_b"):
            out[name, k] = str(d / f"{name}{k}.yak")
            pcount.count_file(paths[name], pcount.CountOpts(
                k=k, chunk_size=cases.CHUNK, device="cpu")).dump(
                    out[name, k])
    return out


@pytest.mark.parametrize("batch", [1000, 4096, 1 << 22])
def test_open_yak_stream_matches_jax(tables, batch):
    """The same (hashes, counts) batches, every one but the last of
    `batch` keys, and the same k and pre."""
    jk, jpre, jb = jfmt.open_yak_stream(tables["reads_a", 33], batch)
    pk, ppre, pb = pfmt.open_yak_stream(tables["reads_a", 33], batch)
    assert (pk, ppre) == (jk, jpre) == (33, 10)
    jb, pb = list(jb), list(pb)
    assert len(pb) == len(jb) >= (2 if batch < 4096 else 1)
    for (jh, jc), (ph, pc) in zip(jb, pb):
        np.testing.assert_array_equal(ph, jh)
        np.testing.assert_array_equal(pc, jc)
        assert ph.dtype == np.uint64 and pc.dtype == np.int32
    assert all(len(h) == batch for h, _c in pb[:-1])


def test_open_yak_stream_errors(tmp_path):
    """A wrong magic or counter-bit field: restore_yak's messages, in
    both packages' words."""
    bad = tmp_path / "bad.yak"
    bad.write_bytes(b"YAK\1" + bytes(12))
    for fmt in (jfmt, pfmt):
        with pytest.raises(ValueError, match="wrong file magic"):
            fmt.open_yak_stream(str(bad))
    bad.write_bytes(b"YAK\2" + np.array([21, 10, 8], "<u4").tobytes())
    for fmt in (jfmt, pfmt):
        with pytest.raises(ValueError, match="saved counter bits 8 != 10"):
            fmt.open_yak_stream(str(bad))


_JAX = {}


def _text(mod, args, **kw):
    buf = io.StringIO()
    mod.main_inspect(*args, out=buf, **kw)
    return buf.getvalue()


BATCH = 7000


@pytest.mark.parametrize("psort", [False, True])
@pytest.mark.parametrize("case,k", [("one", 21), ("one", 33), ("two", 21),
                                    ("two", 33), ("two-m5", 21),
                                    ("two-swapped", 21)])
def test_main_inspect_matches_jax(tables, monkeypatch, psort, k, case):
    """One table: the HS rows.  Two tables: the SN and QV rows, the
    first table streamed in batches of BATCH keys (a partial last one),
    the port's lookups through its query sort (the sort kernel's plain
    version under psort) and the JOIN."""
    monkeypatch.delenv("YAK_TPU_PSORT", raising=False)
    a, b = tables["reads_a", k], tables["reads_b", k]
    args, kw = {"one": ((a,), {}), "two": ((a, b), {}),
                "two-m5": ((a, b), {"max_cnt": 5}),
                "two-swapped": ((b, a), {})}[case]
    if case != "one":
        kw["batch_keys"] = BATCH
    key = (case, k)
    if key not in _JAX:
        _JAX[key] = _text(jinspect, args, **kw)
    if psort:
        monkeypatch.setenv("YAK_TPU_PSORT", "1")
    calls = []
    real = sort.sort
    monkeypatch.setattr(sort, "sort",
                        lambda *a_, **kw_: calls.append(1) or real(*a_, **kw_))
    got = _text(pinspect, args, device="cpu", **kw)
    assert got == _JAX[key]
    lines = got.splitlines()
    if case == "one":
        assert len(lines) > 10 and all(r.startswith("HS\t") for r in lines)
        assert not calls
        return
    assert sum(r.startswith("SN\t") for r in lines) > 10
    assert sum(r.startswith("QV\t") for r in lines) >= 5
    n_keys = len(pfmt.restore_yak(args[0])[2])
    n_batches = -(-n_keys // BATCH)
    assert n_batches >= 3 and n_keys % BATCH
    assert len(calls) == (n_batches if psort else 0)


def test_two_table_lookups_through_lookup_keys(tables, monkeypatch):
    """Each batch of the first table is one lookup_keys call against the
    second table, wide-encoded at k = 33; the last batch is partial."""
    sizes = []
    real = countstep.lookup_keys

    def spy(q, valid, *args, **kw):
        sizes.append((q.numel(), bool(valid.all()), args[3]))
        return real(q, valid, *args, **kw)

    monkeypatch.setattr(countstep, "lookup_keys", spy)
    _text(pinspect, (tables["reads_a", 33], tables["reads_b", 33]),
          device="cpu", batch_keys=4096)
    n = sum(s for s, _v, _w in sizes)
    assert [s for s, _v, _w in sizes[:-1]] == [4096] * (len(sizes) - 1)
    assert 0 < sizes[-1][0] < 4096 and n > 20000
    assert all(v and w for _s, v, w in sizes)


def test_cli_matches_jax(tables):
    """inspect -m 8 of two tables through `python -m yak_tpu_torch`: the
    JAX package's stdout and the port's footer."""
    a, b = tables["reads_a", 21], tables["reads_b", 21]
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "yak_tpu_torch", "inspect",
                          "-m", "8", "--device", "cpu", a, b],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[M::main] CMD: yak_tpu_torch inspect -m 8" in res.stderr
    from yak_tpu import cli as jax_cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        assert jax_cli.main(["inspect", "-m", "8", a, b]) == 0
    assert res.stdout == buf.getvalue() and res.stdout.count("SN\t") > 10
