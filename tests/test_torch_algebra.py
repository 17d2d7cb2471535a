"""The table algebra and print on the CPU: `hash64_inv` against the JAX
package's, the presence-vote merge of cntasm and the membership filter
of subtract / isec against `yak_tpu`'s KmerTable on hand-made tables
(the selected keys in the middle of the other table; garbage beyond a
table's live size), and `recount`, `subtract`, `isec`, `cntasm` and
`print` through both CLIs on the seeded inputs of
tests/torch_algebra_cases.py: `.yak` dumps, stdout and the cntasm
progress lines byte-identical to `yak_tpu`'s at k = 21 and k = 33
(where `yak_tpu` takes k = 33), on both of the port's engines.  Every
comparison is exact."""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_algebra_cases as cases
from yak_tpu import cli as jax_cli
from yak_tpu.ops.hash import hash64_inv as jax_hash64_inv
from yak_tpu.table import KmerTable as JaxTable
from yak_tpu_torch import cli
from yak_tpu_torch.models import count as pcount
from yak_tpu_torch.ops import merge
from yak_tpu_torch.ops.hash import hash64, hash64_inv, kmer_mask
from yak_tpu_torch.ops.keys import torch_to_u64, u64_to_torch
from yak_tpu_torch.table import KmerTable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("k", [1, 21, 31])
def test_hash64_inv_matches_jax(k):
    """The inverse against the JAX package's on random hashes and the
    mask's ends (0 and 4^k - 1), and the round trips through hash64."""
    mask = kmer_mask(k)
    rng = np.random.default_rng(k)
    x = np.concatenate([rng.integers(0, mask, 5000, dtype=np.uint64,
                                     endpoint=True),
                        np.array([0, mask], np.uint64)])
    got = hash64_inv(x, mask)
    np.testing.assert_array_equal(got, jax_hash64_inv(x, mask, ns=np))
    assert got.dtype == np.uint64 and (got <= np.uint64(mask)).all()
    fwd = torch_to_u64(hash64(u64_to_torch(got), mask))
    np.testing.assert_array_equal(fwd, x)
    back = hash64_inv(torch_to_u64(hash64(u64_to_torch(x), mask)), mask)
    np.testing.assert_array_equal(back, x)


def _tables(rng, k, n_a, n_b, shared, cap_a=1 << 14):
    """Two tables' unique raw hashes and counts as numpy: a random key
    set of n_a and one of n_b that shares `shared` keys with it."""
    hi = (1 << 64) if k > 31 else (1 << (2 * k))
    keys = np.unique(rng.integers(0, hi - 1, n_a + n_b, dtype=np.uint64))
    keys = keys[rng.permutation(len(keys))]
    a = np.sort(keys[:n_a])
    b = np.sort(np.concatenate([keys[n_a:n_a + n_b - shared],
                                rng.choice(a, shared, replace=False)]))
    return ((a, rng.integers(1, 40, len(a)).astype(np.int32)),
            (b, rng.integers(1, 40, len(b)).astype(np.int32)))


def _jax_table(k, h, c):
    t = JaxTable(k)
    t._set_pairs(h, c)
    return t


def _port_table(k, h, c, cap, garbage=None):
    """A port table of (h, c) at capacity cap; `garbage`, an rng, fills
    the lanes beyond the live size with keys and counts that break the
    ascending order (keys below the live ones, and the live keys
    again)."""
    keys = np.zeros(cap, np.uint64)
    cnt = np.full(cap, -1, np.int32)
    keys[:len(h)], cnt[:len(h)] = h, c
    if garbage is not None:
        tail = cap - len(h)
        keys[len(h):] = np.concatenate(
            [garbage.choice(h, tail // 2),
             garbage.integers(0, int(h[0]) + 1, tail - tail // 2,
                              dtype=np.uint64)])
        cnt[len(h):] = garbage.integers(0, 1024, tail)
    return KmerTable.from_arrays(keys, cnt, len(h), k, 10, "cpu")


@pytest.mark.parametrize("k", [21, 33])
def test_merge_presence_vote_matches_jax(k):
    """cntasm's presence vote: other's keys with counts in [3, 5] sit in
    the middle of its lanes, between unselected keys; each adds 1 to the
    table's count or creates the key with count 1; the union overflows
    the table's capacity (reserved first), and counts at 1023 stay."""
    rng = np.random.default_rng(k)
    (ha, ca), (hb, cb) = _tables(rng, k, 3000, 9000, 1500)
    ca[:200] = 1023
    cb = np.where((np.arange(len(hb)) > 2000) & (np.arange(len(hb)) < 7000),
                  rng.integers(3, 6, len(hb)), rng.choice([1, 2, 6, 9],
                                                          len(hb)))
    cb = cb.astype(np.int32)
    cb[np.isin(hb, ha[:200])] = 4
    jt = _jax_table(k, ha, ca)
    jt.merge(_jax_table(k, hb, cb), 3, 5)
    pt = _port_table(k, ha, ca, 1 << 12)
    calls = []
    real = merge.merge_reduce

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    merge.merge_reduce = spy
    try:
        pt.merge(_port_table(k, hb, cb, 1 << 14, np.random.default_rng(1)),
                 3, 5)
    finally:
        merge.merge_reduce = real
    assert calls == [{"create": True, "wide": k > 31}]
    jh, jc = jt.items()
    ph, pc = pt.items()
    np.testing.assert_array_equal(ph, jh)
    np.testing.assert_array_equal(pc, jc)
    assert pt.cap >= len(ph) > 1 << 12
    assert (pc == 1023).sum() == 200 and ((pc == 1) & ~np.isin(ph, ha)).any()


@pytest.mark.parametrize("k", [21, 33])
@pytest.mark.parametrize("op", ["subtract", "isec"])
def test_membership_with_garbage_beyond_size_matches_jax(k, op):
    """subtract / isec of a table whose lanes beyond its live size hold
    garbage (unordered keys, some equal to live keys of either table),
    against another whose tail holds garbage too: the same keys and
    counts as the JAX package's on clean tables, and as numpy's set
    operations."""
    rng = np.random.default_rng(100 + k)
    (ha, ca), (hb, cb) = _tables(rng, k, 5000, 4000, 1700)
    jt = _jax_table(k, ha, ca)
    getattr(jt, op)(_jax_table(k, hb, cb))
    pt = _port_table(k, ha, ca, 1 << 13, np.random.default_rng(2))
    getattr(pt, op)(_port_table(k, hb, cb, 1 << 13,
                                np.random.default_rng(3)))
    jh, jc = jt.items()
    ph, pc = pt.items()
    np.testing.assert_array_equal(ph, jh)
    np.testing.assert_array_equal(pc, jc)
    keep = np.isin(ha, hb) == (op == "isec")
    np.testing.assert_array_equal(ph, ha[keep])
    assert len(ph) == (1700 if op == "isec" else 3300)


def test_table_ops_refuse_other_k():
    a = KmerTable(21, device="cpu")
    with pytest.raises(ValueError, match="k=33"):
        a.isec(KmerTable(33, device="cpu"))
    # merge takes a table of another k: its raw hashes, all 64 bits
    rng = np.random.default_rng(4)
    hb = np.unique(rng.integers(0, 1 << 64, 300, dtype=np.uint64))
    a.merge(_port_table(33, hb, np.full(len(hb), 5, np.int32), 1 << 10,
                        rng), 1, 9)
    ah, ac = a.items()
    np.testing.assert_array_equal(np.sort(ah), hb)
    assert (ac == 1).all() and (a.k, a.pre) == (21, 10)
    with pytest.raises(ValueError, match="k <= 31"):
        KmerTable(33, device="cpu").getseq()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The seeded inputs, and the reads' tables at k = 21 and 33."""
    d = tmp_path_factory.mktemp("algebra_inputs")
    paths = cases.write_inputs(str(d))
    for k in (21, 33):
        for name in ("reads_a", "reads_b"):
            paths[f"{name}{k}"] = str(d / f"{name}{k}.yak")
            pcount.count_file(paths[name], pcount.CountOpts(
                k=k, chunk_size=cases.CHUNK, device="cpu")).dump(
                    paths[f"{name}{k}"])
    return paths


def _run(main, argv):
    """(exit code or the exception's type, stdout, the cntasm progress
    lines) of one in-process CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            ret = main(argv)
        except AssertionError:
            ret = "AssertionError"
    lines = [r for r in err.getvalue().splitlines()
             if r.startswith(("[M::cntasm]", "WARNING", "ERROR"))]
    return ret, out.getvalue(), lines


_JAX = {}


def _jax(key, argv, dump):
    if key not in _JAX:
        r = _run(jax_cli.main, argv)
        _JAX[key] = r + (open(dump, "rb").read()
                         if dump and os.path.exists(dump) else None,)
    return _JAX[key]


def _case(inputs, tmp, cmd, k):
    """The argv of a case ('@' for the output file) and its output file
    name, or None."""
    a, b = inputs[f"reads_a{k}"], inputs[f"reads_b{k}"]
    asm = [inputs[f"asm{i}"] for i in range(4)]
    K = f"-K{cases.CHUNK}"
    return {
        "recount": ["recount", "-o", "@", a, inputs["reads_b"]],
        "subtract": ["subtract", "-o", "@", a, b],
        "isec": ["isec", "-o", "@", a, b, a],
        "print": ["print", a],
        "print-c": ["print", "-c", a],
        "cntasm": ["cntasm", f"-k{k}", K, "-o", "@", *asm[:3]],
        "cntasm-c1x2e1s2": ["cntasm", f"-k{k}", K, "-c1", "-x2", "-e1",
                            "-s2", "-o", "@", *asm],
        "cntasm-i": ["cntasm", f"-k{k}", K, "-i", str(tmp / "ca.yak"),
                     "-o", "@", asm[3]],
        "cntasm-i-missing": ["cntasm", f"-k{k}", K, "-i",
                             str(tmp / "none.yak"), "-o", "@", asm[0]],
        **{f"cntasm-i-{other}": ["cntasm", f"-k{k}", K, "-i",
                                 _i_table(inputs, tmp, other), "-o", "@",
                                 asm[3]]
           for other in I_TABLES},
    }[cmd]


# -i tables of another pre or k for cntasm -k21: `yak_tpu`'s cntasm -p12
# and -k17 of two assemblies, and a k = 33 count of the reads
I_TABLES = {"p12": ["-k21", "-p12"], "k17": ["-k17"], "k33": None}


def _i_table(inputs, tmp, other):
    path = tmp / f"ca-{other}.yak"
    if I_TABLES[other] is None:
        return inputs["reads_a33"]
    if not path.exists():
        with contextlib.redirect_stderr(io.StringIO()):
            assert jax_cli.main(["cntasm", *I_TABLES[other],
                                 f"-K{cases.CHUNK}", "-o", str(path),
                                 inputs["asm0"], inputs["asm1"]]) == 0
    return str(path)


CASES = [(c, 21) for c in ("recount", "subtract", "isec", "print", "print-c",
                           "cntasm", "cntasm-c1x2e1s2", "cntasm-i",
                           "cntasm-i-missing", "cntasm-i-p12",
                           "cntasm-i-k17", "cntasm-i-k33")] + \
    [(c, 33) for c in ("recount", "subtract", "isec", "print-c", "cntasm")]


@pytest.mark.parametrize("psort", [False, True])
@pytest.mark.parametrize("cmd,k", CASES)
def test_cli_matches_jax(inputs, tmp_path_factory, monkeypatch, cmd, k,
                         psort):
    """Each command through both CLIs in this process: the exit code,
    stdout, the dump and the cntasm progress, WARNING and ERROR lines
    byte for byte; at k = 33 cntasm exits 1 with the same message and
    print exits non-zero in both (the JAX package by its assertion).
    psort: the port under YAK_TPU_PSORT=1."""
    monkeypatch.delenv("YAK_TPU_PSORT", raising=False)
    tmp = tmp_path_factory.getbasetemp()
    if cmd == "cntasm-i" and not (tmp / "ca.yak").exists():
        with contextlib.redirect_stderr(io.StringIO()):
            assert jax_cli.main(["cntasm", "-k21", f"-K{cases.CHUNK}", "-o",
                                 str(tmp / "ca.yak"), inputs["asm0"],
                                 inputs["asm1"]]) == 0
    argv = _case(inputs, tmp, cmd, k)
    jdump, pdump = (str(tmp / f"{cmd}{k}.{w}.yak") for w in ("jax", "port"))
    want = _jax((cmd, k), [jdump if a == "@" else a for a in argv], jdump)
    if psort:
        monkeypatch.setenv("YAK_TPU_PSORT", "1")
    if os.path.exists(pdump):
        os.unlink(pdump)
    got = _run(cli.main, [pdump if a == "@" else a for a in argv]
               + ["--device", "cpu"])
    got += (open(pdump, "rb").read() if os.path.exists(pdump) else None,)
    if k == 33 and cmd.startswith("print"):
        assert want[0] == "AssertionError" and got[0] == 1
        assert got[2] == ["ERROR: getseq: k=33; a table's k-mers can be "
                          "printed for k <= 31 only"]
        return
    assert got == want
    if k == 33 and cmd == "cntasm":
        assert got[:3] == (1, "", ["ERROR: -k must be <=31"])
        return
    assert got[0] == 0
    if cmd.startswith("print"):
        assert got[1].count("\n") > 20000
        return
    assert len(got[3]) > 100_000
    if cmd.startswith("cntasm"):
        assert len(got[2]) == len(argv) - argv.index("-o") - 2 + \
            (cmd == "cntasm-i-missing")


def test_print_blocks(inputs, monkeypatch):
    """print's text built 1000 k-mers at a time equals the JAX package's
    per-character loop's, with and without counts of one to four
    digits."""
    monkeypatch.setattr(cli, "PRINT_BLOCK", 1000)
    km, c = KmerTable.restore(inputs["reads_a21"], "cpu").getseq()
    c = c.copy()
    c[:4] = [0, 9, 99, 1023]
    seqs = ["".join("ACGT"[(int(x) >> (2 * (20 - j))) & 3]
                    for j in range(21)) for x in km]
    for counts in (False, True):
        text = "".join(cli.kmer_text(km[i:i + 1000], c[i:i + 1000], 21,
                                     counts)
                       for i in range(0, len(km), 1000))
        assert text == "".join(s + (f"\t{cc}" if counts else "") + "\n"
                               for s, cc in zip(seqs, c))


def test_cli_subprocess_dump_to_stdout(inputs, tmp_path):
    """isec through `python -m yak_tpu_torch` with the dump on stdout
    (no -o): the bytes of the JAX package's dump, and the footer."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "yak_tpu_torch", "isec",
                          "--device", "cpu", inputs["reads_a21"],
                          inputs["reads_b21"]],
                         cwd=ROOT, env=env, capture_output=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert b"[M::main] CMD: yak_tpu_torch isec" in res.stderr
    out = str(tmp_path / "isec.yak")
    with contextlib.redirect_stderr(io.StringIO()):
        assert jax_cli.main(["isec", "-o", out, inputs["reads_a21"],
                             inputs["reads_b21"]]) == 0
    assert res.stdout == open(out, "rb").read()


@pytest.mark.parametrize("cmd", ["recount", "cntasm", "subtract", "isec",
                                 "print", "inspect", "sexchr", "groupxy"])
def test_cli_usage(cmd):
    """Too few arguments: the usage on stderr, exit 1, in the JAX
    package's words with the port's name."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.main([cmd, "--device", "cpu"]) == 1
    assert err.getvalue().startswith(f"Usage: yak_tpu_torch {cmd} [")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([cmd])
