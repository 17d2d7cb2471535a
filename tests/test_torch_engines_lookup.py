"""The lookup knobs of the port on the CPU against the JAX package: the
sorted join (`sorttable.lookup`) against `lookup_qpacked` and
`lookup_impl` (packable and wide), the seg-payload qv post
(`countstep.qv_join_post_seg`) against `get_qv_join_post_seg`, and the
stdout of qv, qv -E, chkerr, triobin -p, trioeval, sexchr and inspect
and the dump of subtract byte-equal to `yak_tpu`'s under YAK_TPU_JOIN=0,
YAK_TPU_MARK_COMPACT=0, YAK_TPU_QV_SEG=1 and YAK_TPU_PALLAS=0 (qv also
on a forced mesh), with spies on which kernels' wrappers run.  Every
value is an integer: all comparisons are exact."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_lookup_cases import CHUNK, write_contigs, write_reads
from yak_tpu import cli as jax_cli
from yak_tpu.ops import countstep as jcs
from yak_tpu.ops import sorttable as jst
from yak_tpu_torch import cli
from yak_tpu_torch.ops import compact as pcompact
from yak_tpu_torch.ops import countstep as pcs
from yak_tpu_torch.ops import merge as pmerge
from yak_tpu_torch.ops import sorttable
from yak_tpu_torch.ops.keys import INT64_MAX, encode_wide, u64_to_torch

KNOBS = ("YAK_TPU_PSORT", "YAK_TPU_ENGINE", "YAK_TPU_PALLAS",
         "YAK_TPU_JOIN", "YAK_TPU_MARK_COMPACT", "YAK_TPU_BLOOM_SENTINEL",
         "YAK_TPU_QV_SEG", "YAK_TPU_MESH", "YAK_TPU_PROFILE")


@pytest.fixture
def env(monkeypatch):
    """monkeypatch with every knob unset first."""
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


# -- the sorted join ------------------------------------------------------

@pytest.mark.parametrize("wide,seed", [(False, 21), (False, 22),
                                       (True, 23)])
def test_sorted_join_matches_jax(wide, seed):
    """sorttable.lookup against lookup_qpacked (k <= 31) and lookup_impl
    (packable, and wide for k >= 32): present, absent, repeated and
    invalid queries, the table's garbage beyond its live size."""
    rng = np.random.default_rng(seed)
    top = 1 << 64 if wide else 1 << 62
    cap, n, B = 1024, 700, 3000
    keys = np.unique(rng.integers(0, top, 2 * n, dtype=np.uint64))
    rng.shuffle(keys)
    table = np.zeros(cap, np.uint64)
    tk = np.sort(keys[:n])
    table[:n] = tk
    table[n:] = rng.integers(0, top, cap - n, dtype=np.uint64)
    tc = rng.integers(0, 1024, cap).astype(np.int32)
    q = np.where(rng.random(B) < 0.6, rng.choice(tk, B),
                 rng.choice(keys[n:], B)).astype(np.uint64)
    valid = rng.random(B) > 0.1
    jargs = (jnp.asarray(table), jnp.asarray(tc), jnp.int32(n),
             jnp.asarray(q), jnp.asarray(valid))
    want = [np.asarray(jst.lookup(*jargs, packable=not wide))]
    if not wide:
        want.append(np.asarray(jst.lookup_qpacked(*jargs)))
    tkeys, qraw = u64_to_torch(table), u64_to_torch(q)
    if wide:
        tkeys, qraw = encode_wide(tkeys), encode_wide(qraw)
    got = sorttable.lookup(tkeys, torch.from_numpy(tc),
                           torch.tensor(n, dtype=torch.int32),
                           torch.where(torch.from_numpy(valid), qraw,
                                       INT64_MAX)).numpy()
    for w in want:
        np.testing.assert_array_equal(got, w)
    assert (got >= 0).sum() > B // 3 and (got == -1).sum() > B // 5


# -- the seg-payload qv post ----------------------------------------------

def _seg_step(rng, M, ns, kind):
    """A seeded (vals, valid, meta) of one chunk whose region bounds are
    segment bounds, as _qv_chunk_meta gives them: "head" settles a
    carried sequence (seg 0), "tail" opens one (the last seg), "mid" is
    one middle piece."""
    vals = rng.integers(-1, 40, M).astype(np.int32)
    vals[rng.random(M) < 0.3] = 0
    valid = rng.random(M) < 0.9
    nseq = 1 if kind == "mid" else int(rng.integers(2, ns))
    starts = np.sort(rng.choice(np.arange(1, M), nseq - 1,
                                replace=False)).astype(np.int32)
    starts = np.concatenate([[0], starts]).astype(np.int32)
    meta = np.full(2 * ns + 6, M, np.int32)
    meta[:nseq] = starts
    meta[ns + 1:2 * ns + 1] = 0
    meta[ns + 1:ns + 1 + nseq] = rng.random(nseq) < 0.8
    if kind == "mid":
        meta[2 * ns + 1:] = (0, 0, 0, 1, 1)
    else:
        cont = int(kind in ("tail", "both"))
        head = kind in ("head", "both")
        meta[2 * ns + 1:] = (int(starts[1]) if head else 0,
                             int(starts[-1]) if cont else M,
                             nseq - 1 if cont else 0,
                             int(rng.random() < 0.8), cont)
    return vals, valid, meta


def test_qv_join_post_seg_matches_jax():
    """qv_join_post_seg against get_qv_join_post_seg, fed the same
    key-ordered value stream and its segment payload (the JAX JOIN's
    complement-ordered payload reversed), chained over chunks so the
    device fold state carries across heads, tails and middle pieces;
    and against the port's lane-order post on the same chunks."""
    rng = np.random.default_rng(78)
    M, ns, min_frac = 5000, 16, 0.5
    jst_ = (jnp.zeros(1024, jnp.int64), jnp.int32(-1), jnp.int32(0),
            jnp.zeros(1024, jnp.int64))
    z = (torch.zeros(1024, dtype=torch.int64),
         torch.tensor(-1, dtype=torch.int32),
         torch.tensor(0, dtype=torch.int32),
         torch.zeros(1024, dtype=torch.int64))
    pst, lst = z, z
    jpost = jcs.get_qv_join_post_seg(31, ns, M, min_frac=min_frac)
    for kind in ("tail", "mid", "mid", "head", "both", "plain", "tail",
                 "head"):
        vals, valid, meta = _seg_step(rng, M, ns, kind)
        meta_t = torch.from_numpy(meta)
        seg = torch.where(torch.from_numpy(valid),
                          pcs.seg_of_lane(meta_t, ns, M), pcs.SEG_INVALID)
        perm = rng.permutation(M)          # key order -> lane
        jo = jpost(jnp.asarray(vals[perm]),
                   jnp.asarray(seg.numpy()[perm][::-1].copy()),
                   jnp.asarray(meta), *jst_)
        po = pcs.qv_join_post_seg(torch.from_numpy(vals[perm]),
                                  seg[torch.from_numpy(perm)], meta_t, pst,
                                  ns, M, min_frac)
        lo = pcs.qv_join_post(torch.from_numpy(vals),
                              torch.from_numpy(valid), meta_t, lst, ns, M,
                              min_frac, False)
        assert len(jo) == len(po) == len(lo) == 6
        for j, (a, b, c) in enumerate(zip(jo, po, lo)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                          err_msg=f"{kind} out {j}")
            np.testing.assert_array_equal(b.numpy(), c.numpy(),
                                          err_msg=f"{kind} out {j} (lane)")
        jst_, pst, lst = jo[:4], po[:4], lo[:4]
    assert int(pst[0].sum()) > 0


def test_qv_lookup_seg_is_the_join_in_key_order():
    """qv_lookup_seg's values are lookup_chunk's in ascending key order,
    each beside its lane's segment (SEG_INVALID for invalid lanes)."""
    rng = np.random.default_rng(79)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    codes[1000:1040] = 4
    from yak_tpu_torch.io.pack import pack_planes
    L, k = codes.shape[0], 21
    planes = tuple(torch.from_numpy(p.astype(np.int64))
                   for p in pack_planes(codes[None]))
    carg = ("planes", planes, L)
    h, valid = pcs.extract(carg, k)
    h, valid = h.reshape(-1), valid.reshape(-1)
    table = torch.sort(torch.unique(h[valid])[::2]).values
    cap = table.numel() + 7
    tkeys = torch.cat([table, torch.zeros(7, dtype=torch.int64)])
    tcnt = torch.arange(cap, dtype=torch.int32)
    size = torch.tensor(table.numel(), dtype=torch.int32)
    M = h.numel()
    ns = 16
    meta = torch.full((2 * ns + 6,), M, dtype=torch.int32)
    meta[:3] = torch.tensor([0, 500, 1700])
    vals, seg = pcs.qv_lookup_seg(carg, k, tkeys, tcnt, size, meta, ns)
    lane_vals, _ = pcs.lookup_chunk(carg, k, tkeys, tcnt, size)
    order = torch.sort(torch.where(valid, h, INT64_MAX), stable=True).indices
    np.testing.assert_array_equal(vals.numpy(), lane_vals[order].numpy())
    want = torch.where(valid, pcs.seg_of_lane(meta, ns, M), pcs.SEG_INVALID)
    np.testing.assert_array_equal(torch.sort(seg).values.numpy(),
                                  torch.sort(want).values.numpy())
    np.testing.assert_array_equal(seg.numpy(), want[order].numpy())


# -- whole commands -------------------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Tables that `yak_tpu` counts at k = 31 (a: reads of one genome;
    b: the first 200 of those reads; c: reads of another genome), the
    contigs of a's genome and of c's."""
    d = tmp_path_factory.mktemp("torch_engines_lookup")
    f = {name.replace(".", "_"): str(d / name) for name in
         ("a.fq", "b.fq", "c.fq", "a.fa", "c.fa", "a.yak", "b.yak", "c.yak")}
    write_reads(f["a_fq"], seed=2025, n=500)
    write_reads(f["b_fq"], seed=2025, n=200)
    write_reads(f["c_fq"], seed=2031, n=300)
    write_contigs(f["a_fa"], seed=2025)
    write_contigs(f["c_fa"], seed=2031)
    for t in "abc":
        _jax(["count", "-k31", f"-K{CHUNK}", "-o", f[f"{t}_yak"],
              f[f"{t}_fq"]])
    f["dir"] = d
    return f


def _jax(args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert jax_cli.main(args) == 0
    return out.getvalue()


def _port(args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(args[:1] + ["--device", "cpu"] + args[1:]) == 0
    return out.getvalue()


COMMANDS = {   # name: argv with {file} names of the data fixture
    "qv-p": ["qv", "-p", f"-K{CHUNK}", "{a_yak}", "{a_fa}"],
    "qv-reads": ["qv", f"-K{CHUNK}", "{b_yak}", "{a_fq}"],
    "qv-p-E": ["qv", "-p", "-E", f"-K{CHUNK}", "{b_yak}", "{a_fa}"],
    "chkerr": ["chkerr", f"-K{CHUNK}", "{b_yak}", "{a_fa}"],
    "triobin-p": ["triobin", "-p", f"-K{CHUNK}", "{b_yak}", "{c_yak}",
                  "{a_fa}"],
    "trioeval": ["trioeval", "-e", f"-K{CHUNK}", "{a_yak}", "{c_yak}",
                 "{a_fa}"],
    "sexchr": ["sexchr", f"-K{CHUNK}", "{c_yak}", "{b_yak}", "{a_yak}",
               "{a_fa}", "{c_fa}"],
    "inspect": ["inspect", "{a_yak}", "{b_yak}"],
    "subtract": ["subtract", "-o", "{out}", "{a_yak}", "{b_yak}"],
}


@pytest.fixture(scope="module")
def jax_out(data):
    """yak_tpu's stdout (subtract: its dump's bytes) a command, one run
    each, on demand."""
    cache = {}

    def get(name):
        if name not in cache:
            out = str(data["dir"] / f"jax-{name}.yak")
            text = _jax([a.format(out=out, **data)
                         for a in COMMANDS[name]])
            cache[name] = (open(out, "rb").read() if name == "subtract"
                           else text)
        return cache[name]
    return get


RUNS = [
    ("qv-p", {"YAK_TPU_JOIN": "0"}),
    ("qv-p", {"YAK_TPU_QV_SEG": "1"}),
    ("qv-p", {"YAK_TPU_PALLAS": "0"}),
    ("qv-reads", {"YAK_TPU_QV_SEG": "1"}),
    ("qv-reads", {"YAK_TPU_QV_SEG": "1", "YAK_TPU_JOIN": "0"}),
    ("qv-p-E", {"YAK_TPU_JOIN": "0"}),
    ("qv-p-E", {"YAK_TPU_QV_SEG": "1"}),
    ("qv-p", {"YAK_TPU_MESH": "1", "YAK_TPU_PALLAS": "0"}),
    ("chkerr", {"YAK_TPU_JOIN": "0"}),
    ("chkerr", {"YAK_TPU_MARK_COMPACT": "0"}),
    ("chkerr", {"YAK_TPU_PALLAS": "0"}),
    ("triobin-p", {"YAK_TPU_JOIN": "0"}),
    ("triobin-p", {"YAK_TPU_MARK_COMPACT": "0"}),
    ("trioeval", {"YAK_TPU_MARK_COMPACT": "0"}),
    ("trioeval", {"YAK_TPU_PALLAS": "0"}),
    ("sexchr", {"YAK_TPU_JOIN": "0"}),
    ("sexchr", {"YAK_TPU_PALLAS": "0"}),
    ("inspect", {"YAK_TPU_JOIN": "0"}),
    ("inspect", {"YAK_TPU_PALLAS": "0"}),
    ("subtract", {"YAK_TPU_JOIN": "0"}),
]


@pytest.mark.parametrize("name,knobs", RUNS,
                         ids=[f"{n}-" + "-".join(f"{k[8:]}={v}" for k, v
                                                 in kn.items())
                              for n, kn in RUNS])
def test_command_matches_jax(data, jax_out, env, tmp_path, name, knobs):
    """stdout (subtract: the dump) byte-equal to yak_tpu's under each
    knob, and the wrappers each knob turns off are never called: the
    JOIN under JOIN=0 and PALLAS=0, the compaction under MARK_COMPACT=0
    and PALLAS=0 (the count of a table's restore does not fold); the
    seg-payload lookup taken under QV_SEG=1 where it engages (one
    device, no -E, the JOIN on)."""
    for key, value in knobs.items():
        env.setenv(key, value)
    calls = {"merge_join": 0, "compact": 0, "qv_lookup_seg": 0}

    def counted(mod, fn):
        real = getattr(mod, fn)

        def spy(*a, **kw):
            calls[fn] += 1
            return real(*a, **kw)
        env.setattr(mod, fn, spy)

    counted(pmerge, "merge_join")
    counted(pcompact, "compact")
    counted(pcs, "qv_lookup_seg")
    out = str(tmp_path / "p.yak")
    text = _port([a.format(out=out, **data) for a in COMMANDS[name]])
    got = open(out, "rb").read() if name == "subtract" else text
    assert got == jax_out(name)
    assert len(got) > 100
    join_off = knobs.get("YAK_TPU_JOIN") == "0" or "YAK_TPU_PALLAS" in knobs
    if join_off:
        assert calls["merge_join"] == 0
    elif name != "subtract":
        assert calls["merge_join"] > 0
    if "YAK_TPU_PALLAS" in knobs or "YAK_TPU_MARK_COMPACT" in knobs:
        assert calls["compact"] == 0
    seg = (name in ("qv-p", "qv-reads") and "YAK_TPU_QV_SEG" in knobs
           and not join_off)
    assert (calls["qv_lookup_seg"] > 0) is seg
