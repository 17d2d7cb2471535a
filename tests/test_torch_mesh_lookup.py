"""chkerr, triobin, trioeval and sexchr against a MeshTable on the CPU:
meshes of 4 shards that repeat the CPU device (the routed lookups of
`yak_tpu_torch.parallel.mesh.mesh_routed_groups`, each chunk's post on
its own device), their stdout held byte for byte against `yak_tpu`'s
one-chip output, which tests/test_mesh.py holds `yak_tpu`'s own mesh
to, on both of the port's engines.  The inputs are those of the
one-device tests (tests/torch_lookup_cases.py, torch_trio_cases.py,
torch_algebra_cases.py) at the smallest chunk, so that contigs span
chunks and groups; past the marker budgets (CHKERR_MAX_RUNS,
TRIOBIN_MAX_DIFF, TRIOEVAL_MAX_RUNS patched small) each chunk copies
every marker from its shard.  Then the four commands through the CLI
under YAK_TPU_MESH=1 against `yak_tpu`'s CLI."""

import contextlib
import io

import pytest
import torch

import torch_algebra_cases as acases
import torch_lookup_cases as lcases
import torch_trio_cases as tcases
from yak_tpu import cli as jax_cli
from yak_tpu.models import chkerr as jch
from yak_tpu.models import count as jcount
from yak_tpu.models import sexchr as jsex
from yak_tpu.models import trio as jtrio
from yak_tpu.table import KmerTable as JaxTable
from yak_tpu_torch import cli
from yak_tpu_torch.models import chkerr as pch
from yak_tpu_torch.models import count as pcount
from yak_tpu_torch.models import sexchr as psex
from yak_tpu_torch.models import trio as ptrio
from yak_tpu_torch.ops import countstep as pcs
from yak_tpu_torch.parallel import mesh as pmesh
from yak_tpu_torch.table import KmerTable

CHUNK = 16384
N_DEV = 4


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """chkerr's table (`yak_tpu`'s count of the reads) and contigs; the
    trio pat / mat tables and the child; sexchr's chrY / chrX / PAR
    tables (k = 21) and haplotypes."""
    d = tmp_path_factory.mktemp("mesh_lookup")
    p = {"reads": str(d / "reads.fq"), "contigs": str(d / "contigs.fa"),
         "yak": str(d / "t.yak"), "child": str(d / "child.fa")}
    lcases.write_reads(p["reads"])
    lcases.write_contigs(p["contigs"])
    jcount.count_file(p["reads"], jcount.CountOpts(k=31, chunk_size=CHUNK)) \
        .dump(p["yak"])
    pat, mat, _g = tcases.haplotypes()
    tcases.write_child(p["child"])
    for name, hap, seed, tile in (
            ("pat", pat, 1, (tcases.PAT_INS_AT,
                             tcases.PAT_INS_AT + tcases.PAT_INS)),
            ("mat", mat, 2, None)):
        fq = str(d / f"{name}.fq")
        tcases.write_reads(fq, hap, seed, tile)
        p[name] = str(d / f"{name}.yak")
        jcount.count_file(fq, jcount.CountOpts(k=31, chunk_size=CHUNK)) \
            .dump(p[name])
    p.update(acases.write_inputs(str(d)))
    for name in ("chrY", "chrX", "PAR"):
        p[name + ".yak"] = str(d / f"{name}21.yak")
        pcount.count_file(p[name], pcount.CountOpts(
            k=21, chunk_size=CHUNK, device="cpu")).dump(p[name + ".yak"])
    return p


def _text(fn, *args, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stderr(io.StringIO()):
        fn(*args, out=buf, **kw)
    return buf.getvalue()


_JAX = {}


def jax_text(inputs, cmd, **opts):
    """`yak_tpu`'s one-chip stdout of a case (cached)."""
    key = (cmd, tuple(sorted(opts.items())))
    if key in _JAX:
        return _JAX[key]
    if cmd == "chkerr":
        kind = opts.pop("kind")
        _JAX[key] = _text(jch.main_chkerr, jch.ChkerrOpts(chunk_size=CHUNK,
                                                          **opts),
                          JaxTable.restore(inputs["yak"]), inputs[kind])
    elif cmd == "sexchr":
        _JAX[key] = _text(jsex.main_sexchr,
                          jsex.SexchrOpts(chunk_size=CHUNK),
                          jsex.load_sexchr_tables(*_sexchr_yaks(inputs)),
                          [inputs["hap1"], inputs["hap2"]])
    else:
        t = jtrio.load_trio_tables(inputs["pat"], inputs["mat"],
                                   jtrio.TrioOpts())
        fn = jtrio.main_triobin if cmd == "triobin" else jtrio.main_trioeval
        _JAX[key] = _text(fn, jtrio.TrioOpts(**opts), t, inputs["child"],
                          chunk_cap=CHUNK)
    return _JAX[key]


def _sexchr_yaks(inputs):
    return [inputs[n + ".yak"] for n in ("chrY", "chrX", "PAR")]


def on_mesh(table, n_dev=N_DEV):
    """A one-device table dealt onto a mesh of n_dev CPU shards."""
    return cli._mesh_table(table, pmesh.make_mesh(
        devices=[torch.device("cpu")] * n_dev))


@pytest.fixture
def routed(monkeypatch):
    """The mesh size of each group routed (each `_route` call)."""
    calls = []
    real = pmesh._route

    def spy(hv, mesh):
        assert 1 <= len(hv) <= len(mesh)
        calls.append(len(mesh))
        return real(hv, mesh)
    monkeypatch.setattr(pmesh, "_route", spy)
    return calls


def _engine(monkeypatch, psort):
    monkeypatch.setenv("YAK_TPU_PSORT", "1" if psort else "0")


@pytest.mark.parametrize("psort", [False, True])
@pytest.mark.parametrize("kind,n_dev", [("contigs", 4), ("reads", 4),
                                        ("contigs", 2)])
def test_chkerr(inputs, monkeypatch, routed, psort, kind, n_dev):
    """chkerr -K 16384 of the contigs (a low run across the first chunk
    edge) and of the reads (six chunks, a group of 4 and one of 2)."""
    want = jax_text(inputs, "chkerr", kind=kind)
    _engine(monkeypatch, psort)
    got = _text(pch.main_chkerr, pch.ChkerrOpts(chunk_size=CHUNK),
                on_mesh(KmerTable.restore(inputs["yak"], "cpu"), n_dev),
                inputs[kind])
    assert got == want and got.count("\n") > 20
    assert routed and set(routed) == {n_dev}


@pytest.mark.parametrize("psort", [False, True])
def test_chkerr_budget_overflow(inputs, monkeypatch, psort):
    """A budget of 4 markers a chunk: every chunk copies all of its
    markers from its shard's compacted (or sorted) planes."""
    want = jax_text(inputs, "chkerr", kind="reads")
    _engine(monkeypatch, psort)
    monkeypatch.setattr(pcs, "CHKERR_MAX_RUNS", 4)
    got = _text(pch.main_chkerr, pch.ChkerrOpts(chunk_size=CHUNK),
                on_mesh(KmerTable.restore(inputs["yak"], "cpu")),
                inputs["reads"])
    assert got == want


def _trio_text(inputs, cmd, **opts):
    t = on_mesh(ptrio.load_trio_tables(inputs["pat"], inputs["mat"],
                                       ptrio.TrioOpts(), "cpu"))
    fn = ptrio.main_triobin if cmd == "triobin" else ptrio.main_trioeval
    return _text(fn, ptrio.TrioOpts(**opts), t, inputs["child"],
                 chunk_cap=CHUNK)


@pytest.mark.parametrize("psort", [False, True])
@pytest.mark.parametrize("cmd,opts", [("triobin", {}),
                                      ("triobin", {"print_diff": True}),
                                      ("trioeval", {}),
                                      ("trioeval", {"print_err": True})])
def test_trio(inputs, monkeypatch, routed, psort, cmd, opts):
    """triobin (with -p's difference markers) and trioeval (with -e) of
    the child, whose ctg0 is one type-1 run across a whole chunk."""
    want = jax_text(inputs, cmd, **opts)
    _engine(monkeypatch, psort)
    got = _trio_text(inputs, cmd, **opts)
    assert got == want
    assert routed and set(routed) == {N_DEV}
    if opts.get("print_diff"):
        assert got.count("D\t") > 10000
    if cmd == "trioeval":
        assert got.count("\nS\t") == 36 and "\nW\t" in got


@pytest.mark.parametrize("psort", [False, True])
@pytest.mark.parametrize("cmd,opts", [("triobin", {"print_diff": True}),
                                      ("trioeval", {"print_err": True})])
def test_trio_marker_budget_overflow(inputs, monkeypatch, psort, cmd, opts):
    """TRIOBIN_MAX_DIFF and TRIOEVAL_MAX_RUNS of 64: past the budget each
    chunk copies every marker from its shard; the text is the same."""
    want = jax_text(inputs, cmd, **opts)
    _engine(monkeypatch, psort)
    monkeypatch.setattr(pcs, "TRIOBIN_MAX_DIFF", 64)
    monkeypatch.setattr(pcs, "TRIOEVAL_MAX_RUNS", 64)
    assert _trio_text(inputs, cmd, **opts) == want


@pytest.mark.parametrize("psort", [False, True])
def test_sexchr(inputs, monkeypatch, routed, psort):
    """sexchr of both haplotypes (contigs in pieces across chunks) and
    groupxy on its output."""
    want = jax_text(inputs, "sexchr")
    _engine(monkeypatch, psort)
    t = on_mesh(psex.load_sexchr_tables(*_sexchr_yaks(inputs), "cpu"))
    got = _text(psex.main_sexchr, psex.SexchrOpts(chunk_size=CHUNK), t,
                [inputs["hap1"], inputs["hap2"]])
    assert got == want and got.count("\nS\t") == 18
    assert routed and set(routed) == {N_DEV}
    assert psex.groupxy(io.StringIO(got)) == jsex.groupxy(io.StringIO(want))


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert main(argv) == 0
    return out.getvalue()


@pytest.mark.parametrize("cmd", ["chkerr", "triobin", "trioeval", "sexchr"])
def test_cli_forced_mesh(inputs, monkeypatch, routed, cmd):
    """The four commands through the port's CLI under YAK_TPU_MESH=1 (on
    FORCED_SHARDS shards of the CPU, which the lookups must have been
    routed over) print `yak_tpu`'s CLI stdout; YAK_TPU_MESH=0 keeps the
    port on one device."""
    args = {"chkerr": ["chkerr", "-c", "3", "-s", "4", inputs["yak"],
                       inputs["contigs"]],
            "triobin": ["triobin", "-p", inputs["pat"], inputs["mat"],
                        inputs["child"]],
            "trioeval": ["trioeval", "-e", inputs["pat"], inputs["mat"],
                         inputs["child"]],
            "sexchr": ["sexchr", *_sexchr_yaks(inputs), inputs["hap1"],
                       inputs["hap2"]]}[cmd]
    args = args[:1] + [f"-K{CHUNK}"] + args[1:]
    monkeypatch.delenv("YAK_TPU_MESH", raising=False)
    want = _cli(jax_cli.main, args)
    assert not routed
    monkeypatch.setenv("YAK_TPU_MESH", "1")
    assert _cli(cli.main, args + ["--device", "cpu"]) == want
    assert routed and set(routed) == {pmesh.FORCED_SHARDS}
    monkeypatch.setenv("YAK_TPU_MESH", "0")
    routed.clear()
    assert _cli(cli.main, args + ["--device", "cpu"]) == want
    assert not routed
