"""The port's native reader (`yak_tpu_torch/native`, its own copy of
`fastx.cpp`) against the JAX package's pure-Python reader and packer
(`yak_tpu.io.fasta.FastxReader` + `yak_tpu.io.pack.pack_records`), on
seeded numpy inputs: single-line and multi-line FASTA with N runs,
FASTQ, gzip FASTQ, ragged records with some shorter than k, and one long
contig split with its (k-1)-base halo at a tiny chunk; at the three meta
levels and with min_len.  Every chunk field must be equal: codes, the
bit planes (against `yak_tpu.io.pack.pack_planes` of the codes),
seq_id/pos, the rec_* meta, names and lengths, and n_seq after the
reader is exhausted.  Also: the library's build (where, by which name,
from which sources; side by side in threads; a failed build's warning
and the Python reader), ChunkSource's choice of reader, and a count
through the native reader against `yak_tpu` (the other test files'
workloads take the native reader too, where the library builds)."""

import ctypes
import gzip
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import util
from yak_tpu.io.fasta import FastxReader as JaxFastxReader
from yak_tpu.io.pack import pack_planes as jax_pack_planes
from yak_tpu.io.pack import pack_records as jax_pack_records
from yak_tpu.models import count as jcount
from yak_tpu_torch import native
from yak_tpu_torch.io import chunks
from yak_tpu_torch.io.chunks import ChunkSource
from yak_tpu_torch.models import count as pcount
from yak_tpu_torch.ops.cuda_build import BUILD_DIR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 21


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_native")
    rng = np.random.default_rng(2024)
    genome = util.make_genome(rng, 9000)
    reads = util.mutate_reads(rng, genome, 300, 101, err=0.01, n_rate=0.01)
    util.to_fasta(d / "reads.fa", reads)
    util.to_fasta(d / "multi.fa", reads[:120], line_len=29)
    util.to_fastq(d / "reads.fq", reads)
    with open(d / "reads.fq", "rb") as f, \
            gzip.open(d / "reads.fq.gz", "wb") as g:
        g.write(f.read())
    lens = rng.integers(1, 400, size=60)      # some shorter than k
    util.to_fasta(d / "ragged.fa",
                  [rng.integers(0, 5, size=int(n)) for n in lens],
                  line_len=37)
    util.to_fasta(d / "long.fa", [rng.integers(0, 4, 30_000)])
    return d


def python_chunks(path, chunk_size, k, min_len, with_meta):
    reader = JaxFastxReader(str(path))
    n_seq = 0

    def recs():
        nonlocal n_seq
        for rec in reader:
            if len(rec.seq) >= min_len:
                n_seq += 1
                yield rec

    out = list(jax_pack_records(recs(), chunk_size, k, with_meta=with_meta))
    reader.close()
    return out, n_seq


CASES = {
    "fasta": ("reads.fa", 4096, 0, True),
    "multiline-fasta": ("multi.fa", 4096, 0, True),
    "fastq": ("reads.fq", 4096, 0, True),
    "fastq-gz": ("reads.fq.gz", 4096, 0, True),
    "ragged": ("ragged.fa", 1024, 0, True),
    "ragged-min_len": ("ragged.fa", 1024, K, True),
    "halo-tiny-chunk": ("long.fa", 97, 0, True),
    "meta-records": ("reads.fq.gz", 2048, K, "records"),
    "meta-none": ("multi.fa", 2048, 0, False),
}


@pytest.mark.parametrize("name", CASES)
def test_native_chunks_match_jax_python_reader(data, name):
    fn, chunk_size, min_len, meta = CASES[name]
    want, n_seq = python_chunks(data / fn, chunk_size, K, min_len, meta)
    reader = native.NativePackReader(data / fn, chunk_size, K,
                                     min_len=min_len, with_meta=meta)
    got = list(reader)
    assert len(got) == len(want) > 0
    if name == "halo-tiny-chunk":
        assert len(got) > 300
    for w, g in zip(want, got):
        assert g.n_bases == w.n_bases
        np.testing.assert_array_equal(g.codes, w.codes)
        for gp, wp in zip(g.planes, jax_pack_planes(w.codes)):
            np.testing.assert_array_equal(gp, wp)
        if meta is True:
            np.testing.assert_array_equal(g.seq_id, w.seq_id)
            np.testing.assert_array_equal(g.pos, w.pos)
        else:
            assert g.seq_id is None and g.pos is None
        if meta:
            for f in ("rec_gid", "rec_len", "rec_start", "rec_off0",
                      "rec_take"):
                np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                              err_msg=f)
            assert g.seq_names == w.seq_names
            assert g.seq_lens == w.seq_lens
            if len(w.rec_gid):
                gi = int(w.rec_gid[-1])
                assert g.seq_names[gi] == w.seq_names[gi]
                assert g.seq_lens[gi] == w.seq_lens[gi]
    assert reader.n_seq == n_seq


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.NativePackReader(tmp_path / "none.fa", 4096, K)


def test_library_built_from_the_port_copies():
    """The library sits in build/yak_tpu_torch/, named by the hash of its
    sources and flags; the sources are the port's own files: khlayout.cpp
    a copy of yak_tpu's, fastx.cpp yak_tpu's reader with its producer's
    time counters (`yx_stats`; its chunks are held against yak_tpu's
    reader above)."""
    assert native.available()
    path = native.library_path()
    assert path.parent == BUILD_DIR and path.exists()
    assert path.name.startswith("libyakfastx-")
    for src in native.SOURCES:
        assert src.parent == native.SRC_DIR
    kh = native.SRC_DIR / "khlayout.cpp"
    jax_src = os.path.join(ROOT, "yak_tpu", "native", kh.name)
    assert kh.read_bytes() == open(jax_src, "rb").read()
    assert b"void yx_stats(" in (native.SRC_DIR / "fastx.cpp").read_bytes()


def test_concurrent_builds_load(tmp_path, monkeypatch):
    """Three threads build into an empty directory at once (as pytest's
    workers may): each gets the one library name, and it loads."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with ThreadPoolExecutor(3) as pool:
        paths = list(pool.map(lambda _i: native.build(), range(3)))
    assert len(set(paths)) == 1 and paths[0].parent == tmp_path
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    lib = native._bind(ctypes.CDLL(str(paths[0])))
    assert lib.yx_open is not None


def test_failed_build_takes_python_reader(data, monkeypatch, capsys,
                                         tmp_path):
    """A build that fails (here g++ refuses a flag) warns once on stderr
    and leaves the Python reader, which gives the same chunks."""
    monkeypatch.setattr(native, "_state", {"lib": None, "tried": False})
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS",
                        native.CXX_FLAGS + ("-fno-such-option",))
    assert not native.available()
    err = capsys.readouterr().err
    assert err.startswith("[W::native] build failed, using Python reader")
    src = ChunkSource(data / "reads.fq", 4096, K)
    assert src.reader == "python"
    want, _ = python_chunks(data / "reads.fq", 4096, K, 0, True)
    got = list(src)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.codes, w.codes)
    assert native.available() is False and capsys.readouterr().err == ""
    assert list(tmp_path.iterdir()) == []


def test_chunk_source_reader_choice(data, monkeypatch):
    src = ChunkSource(data / "reads.fa", 4096, K)
    assert src.reader == "native"
    assert list(src) and src.n_seq == 300
    assert ChunkSource(data / "reads.fa", 4096, K,
                       force_python=True).reader == "python"
    monkeypatch.setenv("YAK_TPU_NO_NATIVE", "1")
    assert ChunkSource(data / "reads.fa", 4096, K).reader == "python"
    assert chunks.packed_chunks(data / "reads.fa", 4096, K).reader == \
        "python"


def test_count_through_native_reader_matches_jax(data, monkeypatch,
                                                 tmp_path):
    """count_file of the gzip FASTQ and the ragged FASTA (3-plane and
    periodic chunks, several folds) takes the native reader, uploads its
    planes as they are, and dumps yak_tpu's bytes."""
    readers, planes = [], []

    class Spy(ChunkSource):
        def __iter__(self):
            readers.append(self.reader)
            for packed in super().__iter__():
                planes.append(getattr(packed, "planes", None) is not None)
                yield packed

    monkeypatch.setattr(pcount, "ChunkSource", Spy)
    for fn in ("reads.fq.gz", "ragged.fa"):
        t = pcount.count_file(str(data / fn), pcount.CountOpts(
            k=K, chunk_size=16384, device="cpu"))
        t.dump(str(tmp_path / "p.yak"))
        j = jcount.count_file(str(data / fn), jcount.CountOpts(
            k=K, chunk_size=16384))
        j.dump(str(tmp_path / "j.yak"))
        assert (tmp_path / "p.yak").read_bytes() == \
            (tmp_path / "j.yak").read_bytes()
    assert readers == ["native"] * 2 and planes and all(planes)


def test_native_reader_is_thread_safe_per_reader(data):
    """Two readers of one file in two threads (one parser thread each)
    give the same chunks."""
    out = [None, None]

    def read(i):
        out[i] = [c.codes.copy() for c in native.NativePackReader(
            data / "reads.fq.gz", 2048, K, with_meta=False)]

    ts = [threading.Thread(target=read, args=(i,)) for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts)
    assert len(out[0]) == len(out[1]) > 1
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
