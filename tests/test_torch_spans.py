"""The program's spans and counters (`yak_tpu_torch/spans.py`) on the CPU:
off, a span reads no clock, enters no profiler range and records
nothing, while the phase hooks of the table, the steps and the mesh
functions see the same names in the same order as before the spans;
on (by `enable()` or under a profiler), a -b count and a qv -p record
their spans and the native reader's counters, with
outputs byte-equal to a run with spans off; YAK_TPU_PROFILE's trace
holds the spans."""

import contextlib
import io
import json

import pytest
import torch

from torch_lookup_cases import CHUNK, write_contigs, write_reads
from yak_tpu_torch import cli, spans
from yak_tpu_torch.io.chunks import ChunkSource
from yak_tpu_torch.io.pack import pack_chunk_planes
from yak_tpu_torch.models.count import CountOpts, count
from yak_tpu_torch.models.qv import QvOpts, main_qv
from yak_tpu_torch.ops import countstep
from yak_tpu_torch.parallel import mesh as pmesh
from yak_tpu_torch.table import KmerTable

K = 21
FOLD = ["start", "h2d", "extract", "sort", "gate", "merge", "finalize"]
GROUP = ["start", "h2d", "extract", "route"]
# the hooks' sequences before the spans existed (the parent's seam)
PINNED = {
    "table": FOLD * 3 + ["start", "extract", "sort", "gate", "merge",
                         "finalize"],
    "compact": ["start", "h2d", "extract", "merge", "compact", "finalize"],
    "lookup": ["extract", "sort", "join"] * 2,
    "mesh": (GROUP + ["fold"]) * 3 + (GROUP + ["lookup", "back"]) * 4,
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("spans")
    fq, fa = str(d / "reads.fq"), str(d / "contigs.fa")
    write_reads(fq)
    write_contigs(fa)
    return fq, fa


@pytest.fixture
def fresh():
    spans.enable(False)
    spans.reset()
    yield
    spans.enable(False)
    spans.reset()


def hook_runs(fq, fa, monkeypatch):
    """Each seam's hook sequence: a gated table folding two chunks a
    fold then a hash batch, a compact-engine fold, lookup_chunk and
    qv_lookup_seg on a chunk, a mesh count and its routed lookups."""
    seqs = {n: [] for n in PINNED}
    t = KmerTable(K, cap_log2=10, flush_lanes=2 * (CHUNK - K + 1),
                  device="cpu", bf_shift=20)
    t.phase_hook = seqs["table"].append
    for p in ChunkSource(fq, CHUNK, K, with_meta="records"):
        t.insert_codes(p.codes, planes=p.planes)
    t.flush()
    t.fold_hashes(torch.tensor([5, 7, 5]), torch.ones(3, dtype=torch.bool))
    t.flush()
    with monkeypatch.context() as m:
        m.setenv("YAK_TPU_ENGINE", "compact")
        c = KmerTable(K, cap_log2=10, device="cpu")
        c.phase_hook = seqs["compact"].append
        for p in ChunkSource(fq, CHUNK, K, with_meta="records"):
            c.insert_codes(p.codes, planes=p.planes)
        c.flush()
    p = next(iter(ChunkSource(fa, CHUNK, K, with_meta="records")))
    carg = pack_chunk_planes(p, "cpu")
    countstep.lookup_chunk(carg, K, t.keys, t.cnt, t.size,
                           hook=seqs["lookup"].append)
    meta = torch.full((2 * 4096 + 6,), CHUNK - K + 1, dtype=torch.int32)
    countstep.qv_lookup_seg(carg, K, t.keys, t.cnt, t.size, meta, 4096,
                            hook=seqs["lookup"].append)
    mesh = pmesh.make_mesh(devices=[torch.device("cpu")] * 2)
    mt = pmesh.count_file_mesh(fq, CountOpts(k=K, chunk_size=CHUNK,
                                             device="cpu"), mesh,
                               cap_log2=10, hook=seqs["mesh"].append)
    for _ in pmesh.mesh_routed_groups(fa, mt, CHUNK,
                                      hook=seqs["mesh"].append):
        pass
    return seqs


def count_and_qv(fq, fa, monkeypatch):
    """count -b20 over the reads given twice (the literal two-pass),
    then qv -p of the contigs against its table: (items, qv text)."""
    monkeypatch.setenv("YAK_TPU_BLOOM_TWO_PASS", "1")
    table = count([fq, fq], CountOpts(k=K, bf_shift=20, chunk_size=CHUNK,
                                      device="cpu"))
    out = io.StringIO()
    main_qv(QvOpts(print_each=True, chunk_size=CHUNK), table, fa, out=out)
    keys, cnt = table.items()
    return keys.tobytes() + cnt.tobytes(), out.getvalue()


class _NoClock:
    @staticmethod
    def perf_counter():
        raise AssertionError("a span read the clock while off")


def _no_range(name):
    raise AssertionError(f"a span entered {name} while off")


def test_off_reads_no_clock_and_records_nothing(inputs, fresh, monkeypatch):
    monkeypatch.setattr(spans, "time", _NoClock)
    monkeypatch.setattr(spans, "record_function", _no_range)
    assert not spans.enabled()
    assert hook_runs(*inputs, monkeypatch) == PINNED
    with contextlib.redirect_stderr(io.StringIO()):
        count_and_qv(*inputs, monkeypatch)
    assert spans.snapshot() == {"spans": {}, "counters": {}}


def test_on_records_spans_sizes_and_counters(inputs, fresh, monkeypatch):
    with contextlib.redirect_stderr(io.StringIO()):
        off = count_and_qv(*inputs, monkeypatch)
        spans.enable()
        assert hook_runs(*inputs, monkeypatch) == PINNED
        spans.reset()
        on = count_and_qv(*inputs, monkeypatch)
    assert on == off
    snap = spans.snapshot()
    assert {"table.stage", "table.upload", "table.settle", "table.shrink",
            "count.switch", "count.chunk", "reader.open",
            "fold.extract", "fold.sort", "fold.gate", "fold.merge",
            "fold.finalize", "gate.post", "kernel.merge_reduce",
            "kernel.merge_join", "lookup.extract", "lookup.sort",
            "lookup.join", "reader.fill", "reader.wait", "reader.copy",
            "qv.hist", "qv.meta", "qv.stage", "qv.post", "qv.fold",
            "qv.solve"} <= set(snap["spans"])
    # a fold a pass, each reader's first chunk its fill
    assert snap["spans"]["count.switch"][0] == 1
    assert snap["spans"]["fold.gate"][0] == snap["spans"]["gate.post"][0]
    assert snap["spans"]["reader.fill"][0] == 3       # two passes, qv
    assert all(calls > 0 and s >= 0 for calls, s in snap["spans"].values())
    # a kernel call a fold, a JOIN a lookup
    assert snap["spans"]["kernel.merge_reduce"][0] == \
        snap["spans"]["fold.merge"][0]
    assert snap["spans"]["kernel.merge_join"][0] == \
        snap["spans"]["lookup.join"][0]
    ctr = snap["counters"]
    names = ("input", "pack", "full", "parse", "empty")
    assert all(ctr[f"reader.{n}_s"] >= 0 for n in names)
    assert ctr["reader.pack_s"] > 0 and ctr["reader.parse_s"] > 0


def test_profile_trace_holds_the_spans(inputs, fresh, monkeypatch,
                                       tmp_path):
    """Under YAK_TPU_PROFILE the command's trace carries the program's
    ranges; the spans are on only while the profiler records."""
    prof = tmp_path / "prof"
    monkeypatch.setenv("YAK_TPU_PROFILE", str(prof))
    with contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["count", f"-k{K}", f"-K{CHUNK}", "--device", "cpu",
                         "-o", str(tmp_path / "o.yak"), inputs[0]]) == 0
    trace, = prof.glob("trace-*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert {"yak.table.stage", "yak.fold.merge", "yak.reader.fill"} <= names
    assert not spans.enabled()
    assert spans.snapshot()["spans"]["table.stage"][0] >= 1
