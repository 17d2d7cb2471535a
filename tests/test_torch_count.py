"""The count slice as a whole on the CPU: the port's `.yak` dumps are
byte-identical to the JAX package's for a fixed-length-read FASTQ (the
periodic 2-plane path) and a multi-line FASTA with N runs and sequences
shorter than k (the 3-plane path), through count_file, through several
folds of the table, and through the CLI; and for the `-b` two-pass
protocol (two files, the same file twice, a copy under a second path,
k = 33), through `count` and the CLI."""

import contextlib
import io
import os
import shutil
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest

from yak_tpu import cli as jax_cli
from yak_tpu.io.chunks import ChunkSource as JaxChunkSource
from yak_tpu.models import count as jcount
from yak_tpu.table import KmerTable as JaxTable
from yak_tpu_torch import cli
from yak_tpu_torch.io import yakfmt
from yak_tpu_torch.io.chunks import ChunkSource
from yak_tpu_torch.io.pack import detect_periodic_meta
from yak_tpu_torch.models import count as pcount
from yak_tpu_torch.ops import countstep as pcs
from yak_tpu_torch.table import KmerTable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPH = np.frombuffer(b"ACGT", np.uint8)
READ_LEN = 127
CHUNK = 16384       # the smallest device chunk (models/count._device_chunk)


def _genome(rng, n=8000):
    return rng.integers(0, 4, n)


def _write_fastq(path, rng):
    """Reads of READ_LEN bases: READ_LEN + 1 = 128 divides the chunk, so
    every chunk holds whole reads and takes the periodic path."""
    g = _genome(rng)
    with open(path, "wb") as f:
        for i in range(600):
            s = rng.integers(0, len(g) - READ_LEN)
            r = g[s:s + READ_LEN].copy()
            r[rng.random(READ_LEN) < 0.003] = rng.integers(0, 4)
            if rng.random() < 0.5:
                r = (3 - r)[::-1]
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, ALPH[r].tobytes(),
                                              b"I" * READ_LEN))


def _write_fasta(path, rng):
    g = _genome(rng)
    with open(path, "wb") as f:
        for i in range(200):
            n = int(rng.integers(5, 600))     # some shorter than k
            s = rng.integers(0, len(g) - n)
            seq = ALPH[g[s:s + n]].copy()
            if n > 60:
                seq[rng.integers(0, n - 20):][:15] = ord("N")   # an N run
                seq[rng.integers(0, n, 2)] = ord("n")
            f.write(b">s%d some comment\n" % i)
            b = seq.tobytes()
            for j in range(0, len(b), 60):
                f.write(b[j:j + 60] + b"\n")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("count_inputs")
    rng = np.random.default_rng(2024)
    fq, fa = str(d / "reads.fq"), str(d / "contigs.fa")
    _write_fastq(fq, rng)
    _write_fasta(fa, rng)
    return {"fastq": fq, "fasta": fa}


def _jax_dump(path, out, k=31, chunk=CHUNK):
    t = jcount.count_file(path, jcount.CountOpts(k=k, chunk_size=chunk))
    t.dump(out)
    return open(out, "rb").read()


@pytest.mark.parametrize("kind,periodic", [("fastq", True),
                                           ("fasta", False)])
def test_count_file_dump_matches_jax(inputs, tmp_path, kind, periodic):
    src = inputs[kind]
    pers = [detect_periodic_meta(p) is not None
            for p in ChunkSource(src, CHUNK, 31, min_len=31,
                                 with_meta="records")]
    assert all(pers) if periodic else not any(pers)
    t = pcount.count_file(src, pcount.CountOpts(k=31, chunk_size=CHUNK,
                                                device="cpu"))
    t.dump(str(tmp_path / "port.yak"))
    got = (tmp_path / "port.yak").read_bytes()
    want = _jax_dump(src, str(tmp_path / "jax.yak"))
    assert t.tot > 1000
    assert got == want


@pytest.mark.parametrize("kind", ["fastq", "fasta"])
def test_multi_fold_dump_matches_jax(inputs, tmp_path, kind):
    """A fold per chunk against the table carried between folds; the
    same chunks through the JAX table."""
    src = inputs[kind]
    k, chunk = 25, CHUNK
    tables = [JaxTable(k, cap_log2=14, flush_lanes=chunk),
              KmerTable(k, cap_log2=14, flush_lanes=chunk, device="cpu")]
    n_chunks = 0
    for cs, t in ((JaxChunkSource(src, chunk, k, min_len=k,
                                  with_meta="records", force_python=True),
                   tables[0]),
                  (ChunkSource(src, chunk, k, min_len=k,
                               with_meta="records"), tables[1])):
        n_chunks = 0
        for packed in cs:
            per = detect_periodic_meta(packed)
            t.insert_codes(packed.codes, periodic=per if per else False)
            n_chunks += 1
    assert n_chunks >= 4
    paths = [tmp_path / "jax.yak", tmp_path / "port.yak"]
    for t, p in zip(tables, paths):
        t.dump(str(p))
    assert paths[0].read_bytes() == paths[1].read_bytes()


@pytest.mark.parametrize("kind", ["fastq", "fasta"])
def test_cli_dump_matches_jax(inputs, tmp_path, kind):
    src = inputs[kind]
    out = str(tmp_path / "cli.yak")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run(
        [sys.executable, "-m", "yak_tpu_torch", "count", "-k31",
         f"-K{CHUNK}", "--device", "cpu", "-o", out, src],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[M::main] CMD: yak_tpu_torch count" in res.stderr
    assert open(out, "rb").read() == _jax_dump(src, str(tmp_path / "j.yak"))


def test_restore_roundtrip(inputs, tmp_path):
    t = pcount.count_file(inputs["fasta"], pcount.CountOpts(
        k=31, chunk_size=CHUNK, device="cpu"))
    t.dump(str(tmp_path / "a.yak"))
    r = KmerTable.restore(str(tmp_path / "a.yak"), device="cpu")
    for a, b in zip(r.items(), t.items()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(r.hist(), t.hist())


def test_unported_options_raise(inputs, tmp_path):
    """-X (the byte-exact khashl dump), the last count option the port
    refused, now runs: CountOpts(exact=True) counts the same table as
    without it where no gate runs (the same-file -b shortcut, k = 33
    without -b), and the CLI's -X -b20 exits 0 with a dump of the
    default dump's items in other bytes (tests/test_torch_exact.py holds
    the -X bytes against yak_tpu's)."""
    for opt in (pcount.CountOpts(bf_shift=20, chunk_size=CHUNK, device="cpu"),
                pcount.CountOpts(k=33, chunk_size=CHUNK, device="cpu")):
        with contextlib.redirect_stderr(io.StringIO()):
            a = pcount.count([inputs["fastq"]], opt)
            b = pcount.count([inputs["fastq"]], replace(opt, exact=True))
        for x, y in zip(a.items(), b.items()):
            np.testing.assert_array_equal(x, y)
    outs = [tmp_path / "x.yak", tmp_path / "d.yak"]
    for flags, out in ((["-X"], outs[0]), ([], outs[1])):
        with contextlib.redirect_stderr(io.StringIO()):
            assert cli.main(["count", *flags, "-b20", f"-K{CHUNK}",
                             "--device", "cpu", "-o", str(out),
                             inputs["fastq"]]) == 0
    dumps = [yakfmt.restore_yak(str(p)) for p in outs]
    order = [np.argsort(d[2]) for d in dumps]
    for j in (2, 3):
        np.testing.assert_array_equal(dumps[0][j][order[0]],
                                      dumps[1][j][order[1]])
    assert outs[0].read_bytes() != outs[1].read_bytes()


def test_exact_dump_env_refused(inputs, tmp_path, monkeypatch):
    """YAK_TPU_EXACT_DUMP set to anything means -X, as in the JAX
    package's CLI (yak_tpu/cli.py:99,133): the dump is the JAX package's
    bytes under the same variable, and not the default dump's."""
    monkeypatch.setenv("YAK_TPU_EXACT_DUMP", "1")
    outs = [tmp_path / "port.yak", tmp_path / "jax.yak"]
    for main, dev, out in ((cli.main, ["--device", "cpu"], outs[0]),
                           (jax_cli.main, [], outs[1])):
        with contextlib.redirect_stderr(io.StringIO()):
            assert main(["count", "-k31", f"-K{CHUNK}", *dev, "-o",
                         str(out), inputs["fastq"]]) == 0
    assert outs[0].read_bytes() == outs[1].read_bytes()
    monkeypatch.delenv("YAK_TPU_EXACT_DUMP")
    assert outs[0].read_bytes() != _default_dump(inputs, tmp_path)


def _default_dump(inputs, tmp_path):
    out = tmp_path / "default.yak"
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["count", "-k31", f"-K{CHUNK}", "--device", "cpu",
                         "-o", str(out), inputs["fastq"]]) == 0
    return out.read_bytes()


@pytest.fixture(scope="module")
def bloom_inputs(tmp_path_factory):
    """Two read sets of one genome (different reads, so the gate of
    pass 1 and the recount of pass 2 see different streams), and a copy
    of the first under a second path."""
    d = tmp_path_factory.mktemp("bloom_inputs")
    rng = np.random.default_rng(77)
    g = _genome(rng, 6000)
    paths = {}
    for name in ("a", "b"):
        paths[name] = str(d / f"{name}.fq")
        with open(paths[name], "wb") as f:
            for i in range(700):
                s = rng.integers(0, len(g) - READ_LEN)
                r = g[s:s + READ_LEN].copy()
                r[rng.random(READ_LEN) < 0.005] = rng.integers(0, 4)
                if rng.random() < 0.5:
                    r = (3 - r)[::-1]
                f.write(b"@r%d\n%s\n+\n%s\n" % (i, ALPH[r].tobytes(),
                                                  b"I" * READ_LEN))
    paths["a_copy"] = str(d / "a_copy.fq")
    shutil.copy(paths["a"], paths["a_copy"])
    return paths


BLOOM_RUNS = {   # name -> (input names, k)
    "two_files": (("a", "b"), 31),
    "same_file": (("a", "a"), 31),
    "copy_literal": (("a", "a_copy"), 31),
    "two_files_k33": (("a", "b"), 33),
}


@pytest.mark.parametrize("name", list(BLOOM_RUNS))
def test_bloom_count_dump_matches_jax(bloom_inputs, tmp_path, name):
    """count -b20: the literal two-pass for two paths (gated pass 1,
    destroy_bf, clear, increment-only pass 2, shrink), the one-pass
    shortcut for one path twice; dumps byte-identical to the JAX
    package's, and the copy's literal protocol gives the shortcut's
    table."""
    names, k = BLOOM_RUNS[name]
    files = [bloom_inputs[n] for n in names]
    t = pcount.count(files, pcount.CountOpts(k=k, bf_shift=20,
                                             chunk_size=CHUNK, device="cpu"))
    t.dump(str(tmp_path / "port.yak"))
    jt = jcount.count(files, jcount.CountOpts(k=k, bf_shift=20,
                                              chunk_size=CHUNK))
    jt.dump(str(tmp_path / "jax.yak"))
    got = (tmp_path / "port.yak").read_bytes()
    assert got == (tmp_path / "jax.yak").read_bytes()
    assert t.bf is None and t.tot > 1000
    assert set(t.items()[1].tolist()) <= set(range(2, 1024))
    if name == "copy_literal":
        short = pcount.count([files[0], files[0]], pcount.CountOpts(
            k=k, bf_shift=20, chunk_size=CHUNK, device="cpu"))
        short.dump(str(tmp_path / "short.yak"))
        assert (tmp_path / "short.yak").read_bytes() == got


@pytest.mark.parametrize("args", [["-b20", "-H3"], ["-k33", "-b20"]])
def test_cli_bloom_and_wide_match_jax(bloom_inputs, tmp_path, args):
    out = str(tmp_path / "cli.yak")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        ret = cli.main(["count", *args, f"-K{CHUNK}", "--device", "cpu",
                        "-o", out, bloom_inputs["a"], bloom_inputs["b"]])
    assert ret == 0, err.getvalue()
    assert "distinct k-mers after shrinking" in err.getvalue()
    k = 33 if "-k33" in args else 31
    jt = jcount.count([bloom_inputs["a"], bloom_inputs["b"]], jcount.CountOpts(
        k=k, bf_shift=20, bf_n_hash=3 if "-H3" in args else 4,
        chunk_size=CHUNK))
    jt.dump(str(tmp_path / "jax.yak"))
    assert open(out, "rb").read() == (tmp_path / "jax.yak").read_bytes()


def test_bloom_two_pass_env_runs_literal(bloom_inputs, tmp_path,
                                         monkeypatch):
    """YAK_TPU_BLOOM_TWO_PASS set: one path given twice at -b20 runs the
    literal protocol (yak_tpu/models/count.py:113-114): a gated pass
    that creates, then a pass that increments, with the gate post in
    the first; the dump is the shortcut's bytes and `yak_tpu`'s under
    the same variable."""
    files = [bloom_inputs["a"]] * 2
    opts = pcount.CountOpts(k=31, bf_shift=20, chunk_size=CHUNK,
                            device="cpu")
    pcount.count(files, opts).dump(str(tmp_path / "short.yak"))
    monkeypatch.setenv("YAK_TPU_BLOOM_TWO_PASS", "1")
    creates, posts = [], []
    real_file, real_post = pcount.count_file, pcs.run_bloom_gate_post

    def file_spy(fn, opt, table=None):
        creates.append(table is None)
        return real_file(fn, opt, table)

    def post_spy(*args, **kw):
        posts.append(len(creates))
        return real_post(*args, **kw)

    monkeypatch.setattr(pcount, "count_file", file_spy)
    monkeypatch.setattr(pcs, "run_bloom_gate_post", post_spy)
    pcount.count(files, opts).dump(str(tmp_path / "literal.yak"))
    assert creates == [True, False]
    assert posts and set(posts) == {1}       # gated folds in pass 1 only
    jcount.count(files, jcount.CountOpts(k=31, bf_shift=20,
                                         chunk_size=CHUNK)).dump(
        str(tmp_path / "jax.yak"))
    got = (tmp_path / "literal.yak").read_bytes()
    assert got == (tmp_path / "short.yak").read_bytes()
    assert got == (tmp_path / "jax.yak").read_bytes()
