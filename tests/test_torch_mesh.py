"""The mesh slice on the CPU: counting and lookups on meshes of 2, 4 and
8 shards that repeat the CPU device (`yak_tpu_torch.parallel.mesh`),
held against the one-device port and against `yak_tpu` on the same
seeded input (k = 17, a 20 kbp genome, chunk 2^14, as
tests/test_mesh.py uses).  The JAX side is `yak_tpu`'s one-chip
count_file and qv, which its own tests/test_mesh.py holds its
8-virtual-device mesh to, and its CLI under YAK_TPU_MESH=1 on those
devices.  Items, histograms, dumps and stdout are compared byte for
byte, on both of the port's engines, at k = 17 and k = 33, through the
one-fold-late growth replay, a batch skewed onto one shard, the routed
lookup and qv, and the CLI."""

import contextlib
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import util
from yak_tpu import cli as jax_cli
from yak_tpu.models import count as jcount
from yak_tpu.models import qv as jqv
from yak_tpu.table import KmerTable as JaxTable
from yak_tpu_torch import cli
from yak_tpu_torch.io.chunks import ChunkSource
from yak_tpu_torch.io.pack import pack_chunk_planes
from yak_tpu_torch.models import count as pcount
from yak_tpu_torch.models import qv as pqv
from yak_tpu_torch.ops import countstep
from yak_tpu_torch.ops.keys import u64_to_torch
from yak_tpu_torch.parallel import mesh as pmesh
from yak_tpu_torch.table import KmerTable

CHUNK = 1 << 14
CPU = torch.device("cpu")


def cpu_mesh(n):
    return pmesh.make_mesh(devices=[CPU] * n)


def opts(k=17, **kw):
    return pcount.CountOpts(k=k, chunk_size=CHUNK, cap_log2=12,
                            device="cpu", **kw)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """tests/test_mesh.py's reads, an assembly whose contigs span chunks
    and groups, and `yak_tpu`'s one-chip tables and dumps of the reads
    at k = 17 and 33."""
    d = tmp_path_factory.mktemp("mesh")
    rng = np.random.default_rng(11)
    genome = util.make_genome(rng, 20_000)
    reads = util.mutate_reads(rng, genome, 600, 120, err=0.005, n_rate=0.002)
    util.to_fasta(d / "reads.fa", reads)
    rng = np.random.default_rng(9)
    g = util.make_genome(rng, 80_000)
    util.to_fasta(d / "asm.fa",
                  [np.concatenate([genome[:15_000], g[:40_000]]),
                   util.make_genome(rng, 400),
                   np.concatenate([g[40_000:], genome[5_000:]]),
                   genome[:300]],
                  names=["c1", "junk", "c2", "tiny"])
    paths = {"reads": str(d / "reads.fa"), "asm": str(d / "asm.fa")}
    for k in (17, 33):
        t = jcount.count_file(paths["reads"],
                              jcount.CountOpts(k=k, chunk_size=CHUNK,
                                               cap_log2=12))
        paths[f"jax{k}"] = t
        paths[f"dump{k}"] = str(d / f"jax{k}.yak")
        t.dump(paths[f"dump{k}"])
    return paths


def dump_bytes(table, path):
    with contextlib.redirect_stderr(io.StringIO()):
        table.dump(str(path))
    return open(path, "rb").read()


def assert_same(mt, data, k, tmp_path):
    """Items (as sets, sorted), hist and dump against `yak_tpu`'s
    one-chip table and the one-device port's."""
    jt = data[f"jax{k}"]
    jh, jc = jt.items()
    h, c = mt.items()
    o, jo = np.argsort(h), np.argsort(jh)
    np.testing.assert_array_equal(h[o], jh[jo])
    np.testing.assert_array_equal(c[o], jc[jo])
    np.testing.assert_array_equal(mt.hist(), jt.hist())
    want = open(data[f"dump{k}"], "rb").read()
    assert dump_bytes(mt, tmp_path / "mesh.yak") == want
    single = pcount.count_file(data["reads"], opts(k))
    assert dump_bytes(single, tmp_path / "one.yak") == want


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_mesh_equals_single_chip(data, n_dev, tmp_path):
    mt = pmesh.count_file_mesh(data["reads"], opts(), cpu_mesh(n_dev),
                               cap_log2=14)
    assert mt.n_dev == n_dev and len(mt.shards) == n_dev
    for d, s in enumerate(mt.shards):
        h, _c = s.items()
        assert len(h) and ((h & np.uint64(n_dev - 1)) == d).all()
    assert_same(mt, data, 17, tmp_path)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_mesh_wide_k_equals_single_chip(data, n_dev, tmp_path):
    """k = 33: the owner is the raw hash's low bits, the shards' keys are
    wide-encoded, the dump speaks raw hashes."""
    mt = pmesh.count_file_mesh(data["reads"], opts(33), cpu_mesh(n_dev),
                               cap_log2=14)
    assert all(s.wide for s in mt.shards)
    assert_same(mt, data, 33, tmp_path)


def test_mesh_histogram_matches(data):
    mt = pmesh.count_file_mesh(data["reads"], opts(), cpu_mesh(4),
                               cap_log2=14)
    np.testing.assert_array_equal(mt.hist(), data["jax17"].hist())
    assert mt.hist().sum() == mt.tot == data["jax17"].tot


def test_mesh_recount_matches_single(data, tmp_path):
    """clear_counts, then count_file_mesh into the table, which then only
    increments the keys it has (recount, htab.c:71-75): the assembly's
    counts of the reads' k-mers, equal to `yak_tpu`'s recount."""
    mt = pmesh.count_file_mesh(data["reads"], opts(), cpu_mesh(4),
                               cap_log2=14)
    tot = mt.tot
    mt.clear_counts()
    assert mt.tot == tot and mt.hist()[0] == tot
    pmesh.count_file_mesh(data["asm"], opts(), mt.mesh, table=mt)
    jt = JaxTable.restore(data["dump17"])
    jcount.recount(data["asm"], jt)
    jt.dump(str(tmp_path / "jax.yak"))
    assert mt.tot == tot and mt.hist()[0] < tot // 2
    assert dump_bytes(mt, tmp_path / "mesh.yak") == \
        (tmp_path / "jax.yak").read_bytes()


class _Spy:
    """Stands in for a kernel module inside ops.countstep and records the
    device and lane count of each call of one wrapper."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __getattr__(self, attr):
        fn = getattr(self.module, attr)
        if attr != self.name:
            return fn

        def spy(*args, **kw):
            self.calls.append(args[0].shape[0] if self.name == "sort"
                              else args[3].shape[0])
            return fn(*args, **kw)
        return spy


@pytest.mark.parametrize("psort", [False, True])
@pytest.mark.parametrize("k", [17, 33])
def test_mesh_growth_replay(data, monkeypatch, tmp_path, k, psort):
    """From 2^10 lanes a shard every shard overflows and replays its
    fold one fold late, on the engine the fold took, until it fits."""
    monkeypatch.setenv("YAK_TPU_PSORT", "1" if psort else "0")
    merges = _Spy(countstep.merge, "merge_reduce")
    monkeypatch.setattr(countstep, "merge", merges)
    mt = pmesh.count_file_mesh(data["reads"], opts(k), cpu_mesh(4),
                               cap_log2=10)
    assert all(s.cap > 1 << 10 for s in mt.shards)      # every shard grew
    groups = -(-sum(1 for _ in ChunkSource(data["reads"], CHUNK, k,
                                           min_len=k)) // 4)
    assert len(merges.calls) > 4 * groups               # replays ran
    assert_same(mt, data, k, tmp_path)


@pytest.mark.parametrize("k", [17, 33])
def test_mesh_psort_engine_equals_single(data, monkeypatch, tmp_path, k):
    """Under YAK_TPU_PSORT=1 every shard's fold sorts its routed batch
    through ops/sort.sort and merges it by merge.merge_reduce: one call of
    each a shard a group, each of the routed batch's length."""
    monkeypatch.setenv("YAK_TPU_PSORT", "1")
    sorts = _Spy(countstep.sort, "sort")
    merges = _Spy(countstep.merge, "merge_reduce")
    monkeypatch.setattr(countstep, "sort", sorts)
    monkeypatch.setattr(countstep, "merge", merges)
    routed = []
    route = pmesh._route

    def spy_route(hv, mesh):
        recv, meta = route(hv, mesh)
        routed.extend(h.numel() for h in recv if h.numel())
        return recv, meta
    monkeypatch.setattr(pmesh, "_route", spy_route)
    mt = pmesh.count_file_mesh(data["reads"], opts(k), cpu_mesh(4),
                               cap_log2=14)
    assert sorts.calls == merges.calls == routed and len(routed) >= 8
    assert_same(mt, data, k, tmp_path)


def test_mesh_skewed_batch():
    """Every hash owned by shard 0 (low bits 0): the other shards get
    nothing, shard 0 gets every valid lane, and values come back to the
    lanes they left; a fold and a lookup of the batch on the mesh equal
    a one-device table's."""
    rng = np.random.default_rng(3)
    hv, raw = [], []
    for _ in range(3):
        h = rng.integers(0, 1 << 40, 5000, dtype=np.uint64) & ~np.uint64(3)
        h[:1000] = h[1000:2000]           # repeats
        valid = rng.random(5000) < 0.9
        raw.append((h, valid))
        hv.append((u64_to_torch(h), torch.from_numpy(valid)))
    mesh = cpu_mesh(4)
    recv, meta = pmesh._route(hv, mesh)
    assert [r.numel() for r in recv] == [sum(v.sum() for _h, v in raw),
                                         0, 0, 0]
    np.testing.assert_array_equal(
        recv[0].numpy().view(np.uint64),
        np.concatenate([h[v] for h, v in raw]))
    vals = [r.to(torch.int32) & 0xFFFF for r in recv]
    back = pmesh._route_back(vals, meta, mesh, [5000] * 3)
    for (h, v), b in zip(raw, back):
        want = np.where(v, (h & np.uint64(0xFFFF)).astype(np.int64), -1)
        np.testing.assert_array_equal(b.numpy(), want)
    mt = pmesh.MeshTable(mesh, 21, cap_log2=10)
    one = KmerTable(21, cap_log2=10, cap_hinted=True, device="cpu")
    for (h, v), (th, tv) in zip(raw, hv):
        recv, _meta = pmesh._route([(th, tv)], mesh)
        mt.shards[0].fold_hashes(recv[0], torch.ones_like(recv[0],
                                                          dtype=torch.bool))
        one.fold_hashes(th, tv)
    assert [s.tot for s in mt.shards[1:]] == [0, 0, 0]
    for got, want in zip(mt.items(), one.items()):
        np.testing.assert_array_equal(got, want)


def test_fold_hashes_matches_insert_hashes():
    """fold_hashes (the kernel engine, one fold late) and insert_hashes
    (the plain sort-merge) give the same table, creating and then
    increment-only; through a live filter both gate a creating batch as
    one gating batch, to the same table and filter."""
    rng = np.random.default_rng(5)
    a = KmerTable(33, cap_log2=10, device="cpu")
    b = KmerTable(33, cap_log2=10, device="cpu")
    for create in (True, True, False):
        h = u64_to_torch(rng.integers(0, 1 << 14, 3000, dtype=np.uint64)
                         * np.uint64(0x9E3779B97F4A7C15))
        valid = torch.from_numpy(rng.random(3000) < 0.8)
        a.fold_hashes(h, valid, create)
        b.insert_hashes(h, valid, create)
    assert a.cap > 1 << 10
    for got, want in zip(a.items(), b.items()):
        np.testing.assert_array_equal(got, want)
    gated = [KmerTable(21, device="cpu", bf_shift=20) for _ in range(2)]
    gated[0].fold_hashes(h, valid)
    gated[1].insert_hashes(h, valid)
    for got, want in zip(*(t.items() for t in gated)):
        np.testing.assert_array_equal(got, want)
    assert torch.equal(gated[0].bf, gated[1].bf) and gated[0].bf.any()


def _lookup_cases(data, k):
    """Each chunk of the assembly with records: its hashes and validity
    through the one-device extraction."""
    out = []
    for packed in ChunkSource(data["asm"], CHUNK, k, with_meta="records"):
        if len(packed.rec_gid):
            h, v = countstep.extract(pack_chunk_planes(packed, CPU), k)
            out.append((h.reshape(-1), v.reshape(-1)))
    return out


@pytest.mark.parametrize("psort", [False, True])
def test_mesh_lookup_matches_single(data, monkeypatch, psort):
    """mesh_routed_groups on 8 shards: each chunk's values, in chunk and
    lane order, equal `yak_tpu`'s one-chip lookup_hashes of the same
    hashes, on both engines (psort: the sort kernel's plain version with
    the lane as payload)."""
    monkeypatch.setenv("YAK_TPU_PSORT", "1" if psort else "0")
    mt = pmesh.count_file_mesh(data["reads"], opts(), cpu_mesh(8),
                               cap_log2=14)
    got = [(v, ok) for _group, vals, valid in
           pmesh.mesh_routed_groups(data["asm"], mt, CHUNK)
           for v, ok in zip(vals, valid)]
    want = _lookup_cases(data, 17)
    assert len(got) == len(want) >= 5
    assert sum(int((v > 0).sum()) for v, _ok in got) > 20_000
    for (v, ok), (h, valid) in zip(got, want):
        np.testing.assert_array_equal(ok.numpy(), valid.numpy())
        jv = data["jax17"].lookup_hashes(
            jnp.asarray(h.numpy().view(np.uint64)), jnp.asarray(valid.numpy()))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def _qv(mod, table, path, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stderr(io.StringIO()):
        mod.main_qv(mod.QvOpts(chunk_size=CHUNK, **kw), table, path, out=buf)
    return buf.getvalue()


@pytest.mark.parametrize("psort", [False, True])
@pytest.mark.parametrize("flags", [{}, {"print_each": True},
                                   {"print_err_kmer": True}])
def test_mesh_qv_fused_matches_single(data, monkeypatch, flags, psort):
    """qv against a 4-shard table: stdout byte-identical to `yak_tpu`'s
    one-chip qv, with -p and -E, the contigs spanning chunks and
    groups."""
    monkeypatch.setenv("YAK_TPU_PSORT", "1" if psort else "0")
    mt = pmesh.count_file_mesh(data["reads"], opts(), cpu_mesh(4),
                               cap_log2=14)
    want = _qv(jqv, data["jax17"], data["asm"], **flags)
    assert _qv(pqv, mt, data["asm"], **flags) == want
    assert want.count("\n") > 1000


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        ret = main(argv)
    return ret, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("cmd", ["count", "qv"])
def test_cli_auto_mesh(data, monkeypatch, tmp_path, cmd):
    """count and qv -p through both CLIs under YAK_TPU_MESH=1: `yak_tpu`
    on its 8 virtual devices, the port on FORCED_SHARDS shards of the
    CPU (which it must have routed through); the same dump and stdout.
    YAK_TPU_MESH=0 keeps the port on one device."""
    monkeypatch.setenv("YAK_TPU_MESH", "1")
    calls = []
    route = pmesh._route

    def spy_route(hv, mesh):
        calls.append(len(mesh))
        return route(hv, mesh)
    monkeypatch.setattr(pmesh, "_route", spy_route)
    if cmd == "count":
        args = ["count", "-k17", f"-K{CHUNK}", "-o", "@", data["reads"]]
    else:
        args = ["qv", "-p", f"-K{CHUNK}", data["dump17"], data["asm"]]
    outs = []
    for main, extra in ((jax_cli.main, []), (cli.main, ["--device", "cpu"])):
        dump = tmp_path / f"{len(outs)}.yak"
        ret, out, _err = _cli(main, [str(dump) if a == "@" else a
                                     for a in args] + extra)
        assert ret == 0
        outs.append((out, dump.read_bytes() if dump.exists() else None))
    assert outs[0] == outs[1]
    assert calls and set(calls) == {pmesh.FORCED_SHARDS}
    if cmd == "count":
        assert outs[1][1] == open(data["dump17"], "rb").read()
    else:
        assert outs[1][0].count("\nSQ\t") == 4
    monkeypatch.setenv("YAK_TPU_MESH", "0")
    calls.clear()
    assert _cli(cli.main, [str(tmp_path / "x.yak") if a == "@" else a
                           for a in args] + ["--device", "cpu"])[0] == 0
    assert not calls


def test_count_mesh_bloom(data, tmp_path, monkeypatch):
    """count_mesh with -b over one file takes the same-file shortcut (the
    table of counts >= 2, the bytes of `yak_tpu`'s -b count); the literal
    two-pass over a hard link, or forced by YAK_TPU_BLOOM_TWO_PASS, gives
    the same bytes through the shards' filter slices, as does the CLI,
    which runs it on the mesh; a gated pass 1 alone equals a one-device
    table's folding the same two chunks a fold."""
    monkeypatch.delenv("YAK_TPU_BLOOM_TWO_PASS", raising=False)
    o = opts(bf_shift=20)
    files = [data["reads"], data["reads"]]
    mt = pmesh.count_mesh(files, o, cpu_mesh(4), cap_log2=14)
    with contextlib.redirect_stderr(io.StringIO()):
        jt = jcount.count(files, jcount.CountOpts(k=17, chunk_size=CHUNK,
                                                  bf_shift=20))
    jt.dump(str(tmp_path / "jax.yak"))
    want = (tmp_path / "jax.yak").read_bytes()
    assert dump_bytes(mt, tmp_path / "mesh.yak") == want
    assert mt.hist()[1] == 0 and mt.tot < data["jax17"].tot
    link = str(tmp_path / "reads2.fa")
    os.link(data["reads"], link)
    for args, env in (((data["reads"], link), None),
                      ((data["reads"],), "1")):
        if env:
            monkeypatch.setenv("YAK_TPU_BLOOM_TWO_PASS", env)
        with contextlib.redirect_stderr(io.StringIO()):
            lit = pmesh.count_mesh(list(args), o, cpu_mesh(4))
        assert all(s.bf is None for s in lit.shards)
        assert dump_bytes(lit, tmp_path / "lit.yak") == want
    pass1 = pmesh.count_file_mesh(data["reads"], o, cpu_mesh(2))
    one = KmerTable(17, cap_log2=12, device="cpu", bf_shift=20,
                    flush_lanes=2 * (CHUNK - 17 + 1))
    for packed in ChunkSource(data["reads"], CHUNK, 17, min_len=17):
        one.insert_codes(packed.codes)
    (h, c), (oh, oc) = pass1.items(), one.items()
    np.testing.assert_array_equal(h[np.argsort(h)], oh)
    np.testing.assert_array_equal(c[np.argsort(h)], oc)
    assert all(s.bf is not None for s in pass1.shards)
    monkeypatch.setenv("YAK_TPU_MESH", "1")
    meshes = []
    real = pmesh.count_file_mesh
    monkeypatch.setattr(pmesh, "count_file_mesh",
                        lambda fn, opt, mesh, **kw: meshes.append(len(mesh))
                        or real(fn, opt, mesh, **kw))
    out = tmp_path / "cli.yak"
    assert _cli(cli.main, ["count", "-k17", "-b20", f"-K{CHUNK}", "-o",
                           str(out), data["reads"], link,
                           "--device", "cpu"])[0] == 0
    assert meshes == [pmesh.FORCED_SHARDS] * 2
    assert out.read_bytes() == want


def test_make_mesh():
    """A power of two of devices, which may repeat; CUDA devices that do
    not exist are refused, never replaced by the CPU."""
    assert pmesh.make_mesh(devices=["cpu"] * 8) == (CPU,) * 8
    assert pmesh.make_mesh(2, devices=["cpu"] * 8) == (CPU,) * 2
    for bad in ({"devices": ["cpu"] * 3}, {"devices": []},
                {"n_devices": 4, "devices": ["cpu"] * 2}):
        with pytest.raises(ValueError):
            pmesh.make_mesh(**bad)
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="CUDA devices"):
        pmesh.make_mesh(n + 1)
    with pytest.raises(ValueError, match="pre"):
        pmesh.MeshTable(cpu_mesh(4), 17, pre=1)
