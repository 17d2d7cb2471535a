"""The -b two-pass on a mesh on the CPU (`yak_tpu_torch.parallel.mesh`
with filter slices): meshes of 2 and 4 shards that repeat the CPU
device, held against `yak_tpu` on the same seeded inputs.

The cheap gate's answer depends on where a gating batch ends, so the
mesh is held against `yak_tpu`'s one-chip KmerTable folding D chunks a
fold (flush_lanes = D * (chunk - k + 1)), whose gating batches are the
mesh's groups, as tests/test_mesh.py aligns `yak_tpu`'s own mesh: the
literal two-pass over a hard link, over two distinct files on both of
the port's engines, at k = 17 and 33, and from a table small enough
that every shard's gated fold replays.  The serial-exact gate (-X) does
not depend on the batches: its dump is held against `yak_tpu count -X`,
from count_mesh and through the CLI under YAK_TPU_MESH=1.  Each
shard's filter slice after pass 1 is the same shards of `yak_tpu`'s
one-chip filter, bit for bit; the -X refusal follows
`exact_gate_fits` with the shard bits taken off."""

import contextlib
import gzip
import io
import os

import numpy as np
import pytest
import torch

import util
from yak_tpu import cli as jax_cli
from yak_tpu.io.chunks import ChunkSource as JaxChunkSource
from yak_tpu.ops.bloom import exact_gate_fits as jax_exact_gate_fits
from yak_tpu.table import KmerTable as JaxTable
from yak_tpu_torch import cli
from yak_tpu_torch.io.exactdump import dump_yak_exact
from yak_tpu_torch.models import count as pcount
from yak_tpu_torch.ops import bloom
from yak_tpu_torch.parallel import mesh as pmesh
from yak_tpu_torch.table import KmerTable

CHUNK = 1 << 14
PRE = 10
CPU = torch.device("cpu")


def cpu_mesh(n):
    return pmesh.make_mesh(devices=[CPU] * n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A FASTA of reads with errors and N, a hard link to it, and a gzip
    FASTQ of other reads of the same genome with 5 % errors (two
    distinct files: pass 1 admits the FASTQ's false-positive
    singletons, which pass 2 then counts)."""
    d = tmp_path_factory.mktemp("mesh_bloom")
    rng = np.random.default_rng(11)
    genome = util.make_genome(rng, 20_000)
    fa = str(d / "reads.fa")
    util.to_fasta(fa, util.mutate_reads(rng, genome, 600, 120, err=0.005,
                                        n_rate=0.002))
    link = str(d / "link.fa")
    os.link(fa, link)
    fq = str(d / "reads2.fq")
    util.to_fastq(fq, util.mutate_reads(rng, genome, 1200, 127, err=0.05))
    with open(fq, "rb") as f, gzip.open(fq + ".gz", "wb") as g:
        g.write(f.read())
    return {"fa": fa, "link": link, "fq": fq + ".gz", "dir": d}


_JAX = {}


def jax_two_pass(files, pair, k, bf_shift, n_dev, pass1_only=False):
    """`yak_tpu`'s one-chip -b two-pass over files[pair[0]] then
    files[pair[1]], folding n_dev chunks a fold (cached)."""
    key = (pair, k, bf_shift, n_dev, pass1_only)
    if key not in _JAX:
        t = JaxTable(k, PRE, cap_log2=12, bf_shift=bf_shift,
                     flush_lanes=n_dev * (CHUNK - k + 1))
        for name, create in zip(pair, (True, False)):
            for packed in JaxChunkSource(files[name], CHUNK, k, min_len=k,
                                         with_meta=False):
                t.insert_codes(packed.codes, create_new=create)
            t.flush()       # as count_file's closing line does
            if pass1_only:
                _JAX[key] = np.asarray(t.bf).view(np.int32)
                return _JAX[key]
            if create:
                t.destroy_bf()
                t.clear_counts()
        t.shrink(2, 1023)
        with contextlib.redirect_stderr(io.StringIO()):
            t.dump(str(files["dir"] / f"jax{len(_JAX)}.yak"))
        _JAX[key] = (t.items(), t.hist(),
                     open(files["dir"] / f"jax{len(_JAX)}.yak", "rb").read())
    return _JAX[key]


def opts(k=17, **kw):
    return pcount.CountOpts(k=k, chunk_size=CHUNK, cap_log2=12, device="cpu",
                            **kw)


def assert_same(mt, want, tmp_path):
    """Items (sorted), hist and dump bytes against `yak_tpu`'s."""
    (jh, jc), jhist, jdump = want
    h, c = mt.items()
    o, jo = np.argsort(h), np.argsort(jh)
    np.testing.assert_array_equal(h[o], jh[jo])
    np.testing.assert_array_equal(c[o], jc[jo])
    np.testing.assert_array_equal(mt.hist(), jhist)
    with contextlib.redirect_stderr(io.StringIO()):
        mt.dump(str(tmp_path / "mesh.yak"))
    assert (tmp_path / "mesh.yak").read_bytes() == jdump


@pytest.mark.parametrize("n_dev", [2, 4])
def test_literal_two_pass_hard_link(files, n_dev, monkeypatch, tmp_path):
    """Two paths to one file take the literal two-pass (gated pass 1,
    destroy, clear, increment-only pass 2, shrink), as in `yak_tpu`; the
    filter is gone after it, and the table is every count >= 2."""
    monkeypatch.delenv("YAK_TPU_BLOOM_TWO_PASS", raising=False)
    gated = []
    real = KmerTable._queue_fold
    monkeypatch.setattr(KmerTable, "_queue_fold",
                        lambda self, carg, lanes, g: gated.append(g)
                        or real(self, carg, lanes, g))
    with contextlib.redirect_stderr(io.StringIO()):
        mt = pmesh.count_mesh([files["fa"], files["link"]], opts(bf_shift=20),
                              cpu_mesh(n_dev), cap_log2=14)
    assert all(s.bf is None for s in mt.shards)
    assert sum(gated) >= n_dev and not all(gated)
    want = jax_two_pass(files, ("fa", "link"), 17, 20, n_dev)
    assert_same(mt, want, tmp_path)
    assert mt.hist()[1] == 0


@pytest.mark.parametrize("n_dev,k,psort", [(2, 17, False), (4, 17, False),
                                           (4, 17, True), (4, 33, False)])
def test_two_files_cheap_gate(files, n_dev, k, psort, monkeypatch, tmp_path):
    """Pass 1 over the gzip FASTQ (5 % errors, ten chunks), pass 2 over
    the FASTA, at -b19 (one 512-bit block a pre-bit shard): which
    singletons pass 1 admits depends on the gating batches, here a
    group's hashes a shard, and the table differs from a one-fold
    pass 1's; on the psort engine the gated folds take the plain gate
    post and the sort's plain version, at k = 33 the wide keys."""
    monkeypatch.setenv("YAK_TPU_PSORT", "1" if psort else "0")
    mt = pmesh.count_mesh([files["fq"], files["fa"]], opts(k, bf_shift=19),
                          cpu_mesh(n_dev), cap_log2=14)
    want = jax_two_pass(files, ("fq", "fa"), k, 19, n_dev)
    assert_same(mt, want, tmp_path)
    if k == 17:
        one_fold = jax_two_pass(files, ("fq", "fa"), k, 19, 16)
        assert len(one_fold[0][0]) != len(want[0][0])


def test_pass1_slices_are_the_one_chip_filter(files):
    """After the gated pass 1 each shard's slice of -b20 (2^(20 - log2 D)
    bits) holds its own pre-bit shards of `yak_tpu`'s one-chip filter,
    in order, bit for bit."""
    for n_dev in (2, 4):
        mt = pmesh.count_file_mesh(files["fq"], opts(bf_shift=20),
                                   cpu_mesh(n_dev), cap_log2=14)
        want = jax_two_pass(files, ("fq", "fa"), 17, 20, n_dev,
                            pass1_only=True)
        rows = want.reshape(1 << PRE, -1)
        assert rows.any()
        for d, s in enumerate(mt.shards):
            assert s.shard_shift == n_dev.bit_length() - 1
            assert s.bf.numel() == (1 << (20 - s.shard_shift - 5))
            np.testing.assert_array_equal(s.bf.numpy(),
                                          rows[d::n_dev].reshape(-1))


def test_replay_rolls_back_each_slice(files, monkeypatch, tmp_path):
    """From 2^8 lanes a shard every shard's gated fold overflows and
    replays one fold late: each shard first takes its own slice back by
    the fold's undo record, and the table is the same."""
    rolled = []
    real = bloom.rollback
    monkeypatch.setattr(bloom, "rollback",
                        lambda bf, undo: rolled.append(bf.numel())
                        or real(bf, undo))
    mt = pmesh.count_mesh([files["fq"], files["fa"]], opts(bf_shift=20),
                          cpu_mesh(2), cap_log2=8)
    assert len(rolled) >= 2 and set(rolled) == {1 << (20 - 1 - 5)}
    assert all(s.cap > 1 << 8 for s in mt.shards)
    assert_same(mt, jax_two_pass(files, ("fq", "fa"), 17, 20, 2), tmp_path)


@pytest.fixture(scope="module")
def jax_exact_dump(files):
    """`yak_tpu count -X -k19 -b19` of the gzip FASTQ then the FASTA."""
    out = str(files["dir"] / "jax_x.yak")
    with contextlib.redirect_stderr(io.StringIO()):
        assert jax_cli.main(["count", "-X", "-k19", "-b19", f"-K{CHUNK}",
                             "-o", out, files["fq"], files["fa"]]) == 0
    return open(out, "rb").read()


@pytest.mark.parametrize("n_dev", [2, 4])
def test_exact_two_files(files, jax_exact_dump, n_dev, tmp_path):
    """-X over two distinct files at -b19 (one 512-bit block a pre-bit
    shard, so keys of one batch cross each other's bits): each shard's
    serial rank of a hash is src * M + lane, so its pass 1 is the
    serial one and the dump is `yak_tpu`'s bytes.  The cheap gate's
    table differs, so the input needs the ranks."""
    with contextlib.redirect_stderr(io.StringIO()):
        mt = pmesh.count_mesh([files["fq"], files["fa"]],
                              opts(19, bf_shift=19, exact=True),
                              cpu_mesh(n_dev), cap_log2=14)
        cheap = pmesh.count_mesh([files["fq"], files["fa"]],
                                 opts(19, bf_shift=19), cpu_mesh(n_dev),
                                 cap_log2=14)
    out = str(tmp_path / "x.yak")
    dump_yak_exact(out, mt, [files["fq"], files["fa"]], bf_shift=19)
    assert open(out, "rb").read() == jax_exact_dump
    assert cheap.tot != mt.tot
    with pytest.raises(ValueError, match="cross-check"):
        dump_yak_exact(str(tmp_path / "c.yak"), cheap,
                       [files["fq"], files["fa"]], bf_shift=19)


def test_exact_cli_on_forced_mesh(files, jax_exact_dump, monkeypatch,
                                  tmp_path):
    """count -X -b19 through the CLI under YAK_TPU_MESH=1: the literal
    two-pass on FORCED_SHARDS shards of the CPU, the dump `yak_tpu`'s."""
    monkeypatch.setenv("YAK_TPU_MESH", "1")
    meshes = []
    real = pmesh.count_file_mesh
    monkeypatch.setattr(pmesh, "count_file_mesh",
                        lambda fn, opt, mesh, **kw: meshes.append(len(mesh))
                        or real(fn, opt, mesh, **kw))
    out = str(tmp_path / "cli.yak")
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["count", "-X", "-k19", "-b19", f"-K{CHUNK}",
                         "--device", "cpu", "-o", out, files["fq"],
                         files["fa"]]) == 0
    assert meshes == [pmesh.FORCED_SHARDS] * 2
    assert open(out, "rb").read() == jax_exact_dump


def test_exact_gate_fits_with_shard_bits(files, monkeypatch, tmp_path):
    """exact_gate_fits with shard_shift agrees with `yak_tpu`'s; -X -b37
    at the default chunk fits on a mesh of 4 (rank bound 4 * M) and is
    refused on one device; a mesh whose packed key would not fit refuses
    before it makes its filter slices, through count_mesh and the CLI
    (exit 1, the one-device message)."""
    m = (1 << 23) - 30
    for b in (19, 24, 37, 40, 46, 47):
        for shift in (0, 1, 2, 3):
            for bound in (2 * m, 4 * m, 8 * m, 1 << 20):
                assert bloom.exact_gate_fits(b, 4, bound, shift) == \
                    jax_exact_gate_fits(b, 4, bound, shift)
    assert bloom.exact_gate_fits(37, 4, 4 * m, 2)
    assert not bloom.exact_gate_fits(37, 4, 2 * (2 * m) + 4096)
    # chunk 2^14, D = 2: rank bound 2 * 16368 (15 bits), 46 bits of
    # position at -b47: 46 + 15 + 3 = 64
    assert bloom.exact_gate_fits(46, 4, 2 * (CHUNK - 18), 1)
    assert not bloom.exact_gate_fits(47, 4, 2 * (CHUNK - 18), 1)
    made = []
    real = bloom.make_bloom
    monkeypatch.setattr(bloom, "make_bloom",
                        lambda n, dev: made.append(n) or real(n, dev))
    with pytest.raises(ValueError, match="cannot engage"):
        pmesh.count_mesh([files["fq"], files["fa"]],
                         opts(19, bf_shift=47, exact=True), cpu_mesh(2))
    assert not made
    monkeypatch.setenv("YAK_TPU_MESH", "1")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.main(["count", "-X", "-k19", "-b47", f"-K{CHUNK}",
                         "--device", "cpu", "-o", str(tmp_path / "r.yak"),
                         files["fq"], files["fa"]]) == 1
    assert "cannot engage the serial-exact Bloom gate" in err.getvalue()
