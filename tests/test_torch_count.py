"""The count slice as a whole on the CPU: the port's `.yak` dumps are
byte-identical to the JAX package's for a fixed-length-read FASTQ (the
periodic 2-plane path) and a multi-line FASTA with N runs and sequences
shorter than k (the 3-plane path), through count_file, through several
folds of the table, and through the CLI."""

import os
import subprocess
import sys

import numpy as np
import pytest

from yak_tpu.io.chunks import ChunkSource as JaxChunkSource
from yak_tpu.models import count as jcount
from yak_tpu.table import KmerTable as JaxTable
from yak_tpu_torch.io.chunks import ChunkSource
from yak_tpu_torch.io.pack import detect_periodic_meta
from yak_tpu_torch.models import count as pcount
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


def test_unported_options_raise(inputs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pcount.count([inputs["fastq"]], pcount.CountOpts(bf_shift=20,
                                                          device="cpu"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pcount.count_file(inputs["fastq"], pcount.CountOpts(k=33,
                                                            device="cpu"))
