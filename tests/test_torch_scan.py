"""The last set lane (ops/scan.last_set_lane): on the CPU its plain
version, torch.cummax, against numpy's running maximum; a numpy model of
the CUDA kernel's tile decomposition (csrc/scan.cu: slices, warp
prefixes, the (slice, warp) scan and the look-back that stops at the
nearest deciding tile) against the same; the two gate-post sites that
call it (countstep._runs, bloom_insert's sparse tail) against the
torch.cummax formulation they had, with scan.last_set_lane swapped for
the scatter version (sorttable.last_set_lane_scatter); that only the
default engine's gate posts call it, and the plain paths (the
sort-merge engines, their gate, the sorted join) never do; and, on a
CUDA card, the kernel against torch.cummax, the plain gate post at a
sparse-tail geometry against the CPU's, and the sort-merge engines'
gate there with no launch.  Every value is an integer: all comparisons
are exact.

This file imports no JAX, so that on the card it runs on its own:
`python -m pytest --noconftest tests/test_torch_scan.py`."""

import numpy as np
import pytest
import torch

from yak_tpu_torch.ops import bloom, countstep, scan
from yak_tpu_torch.ops import sorttable as st
from yak_tpu_torch.ops.keys import INT64_MAX, i32_bits, u64_to_torch
from yak_tpu_torch.ops.sorttable import last_set_lane_scatter

NT, Q, VEC = 256, 8, 4             # csrc/scan.cu: threads, slices, lanes
NW = NT // 32
TILE = NT * Q * VEC                # 8192 lanes
PRE, N_HASH = 10, 4


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs; skips where there is none
    (a CUDA kernel has no CPU mode)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card for the hand-written kernel")
    return torch.device("cuda")


def expected(mask):
    """The running maximum of the set lanes' indices, -1 before the
    first (int32)."""
    lane = np.arange(len(mask))
    return np.maximum.accumulate(np.where(mask, lane, -1)).astype(np.int32)


def _density(n, p, seed, lane0=None):
    mask = np.random.default_rng(seed).random(n) < p
    if lane0 is not None:
        mask[0] = lane0
    return mask


def _runs(n, seed):
    rng = np.random.default_rng(seed)
    return np.resize(np.repeat(rng.random(n // 8) < 0.5,
                               rng.integers(1, 16, n // 8)), n)


CASES = {
    "n1_set": lambda: np.ones(1, bool),
    "n1_unset": lambda: np.zeros(1, bool),
    "tile_minus_1": lambda: _density(TILE - 1, 0.5, 1),
    "tile": lambda: _density(TILE, 0.5, 2),
    "tile_plus_1": lambda: _density(TILE + 1, 0.5, 3, lane0=False),
    "partial_tile": lambda: _density(777, 0.3, 4),
    "tiles_7_ragged": lambda: _density(7 * TILE + 123, 0.5, 5),
    "all_false": lambda: np.zeros(3 * TILE + 5, bool),
    "all_true": lambda: np.ones(3 * TILE + 5, bool),
    "lane0_unset": lambda: _density(4 * TILE, 0.5, 6, lane0=False),
    "density_0.001": lambda: _density(9 * TILE + 7, 0.001, 7),
    "density_0.5": lambda: _density(9 * TILE + 7, 0.5, 8),
    "density_0.999": lambda: _density(9 * TILE + 7, 0.999, 9),
    "one_set_lane_last": lambda: np.eye(1, 5 * TILE, 5 * TILE - 1,
                                        dtype=bool)[0],
    "runs": lambda: _runs(6 * TILE, 10),
}


# -- the plain version on the CPU -------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_last_set_lane_cpu(case, monkeypatch):
    """On the CPU last_set_lane is torch.cummax (one call, no launch),
    for bool and uint8 masks."""
    mask = CASES[case]()
    calls = []
    cummax = torch.cummax
    monkeypatch.setattr(torch, "cummax",
                        lambda *a, **k: calls.append(1) or cummax(*a, **k))
    launches = scan.last_set_lane.launches
    for m in (torch.from_numpy(mask), torch.from_numpy(mask.astype(np.uint8))):
        got = scan.last_set_lane(m)
        assert got.dtype == torch.int32 and got.shape == m.shape
        np.testing.assert_array_equal(got.numpy(), expected(mask))
    assert len(calls) == 2 and scan.last_set_lane.launches == launches


def test_last_set_lane_rejects_bad_inputs():
    m = torch.ones(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        scan.last_set_lane(m.to(torch.int32))
    with pytest.raises(ValueError):
        scan.last_set_lane(m[::2])
    with pytest.raises(ValueError):
        scan.last_set_lane(m.reshape(2, 4))
    with pytest.raises(ValueError, match="2\\^31"):
        scan.last_set_lane(torch.empty(1 << 31, dtype=torch.bool,
                                       device="meta"))


# -- a numpy model of the kernel's tiles ------------------------------------

def _look_back(st, t):
    """The kernel's look_back over status words st ((flag, value + 1),
    flag "A" = the tile's own lanes, "I" = inclusive, None =
    unpublished): 32 words a step, nearest first; the nearest word that
    is inclusive or holds a set lane decides, and a step whose words up
    to it are not all published would wait.  Returns (value + 1, steps)."""
    j, steps = t - 1, 0
    while True:
        steps += 1
        w = [st[j - lane] if j - lane >= 0 else ("I", 0)
             for lane in range(32)]
        dec = [lane for lane in range(32)
               if w[lane] and (w[lane][0] == "I" or w[lane][1] != 0)]
        first = dec[0] if dec else 31
        assert all(w[lane] for lane in range(first + 1)), "would wait"
        if dec:
            return w[first][1], steps
        j -= 32


def tile_model(mask, order):
    """last_set_lane as csrc/scan.cu decomposes it, in numpy: TILE-lane
    tiles, slot s = ((q * NW + w) * 32 + l) * VEC + r of a tile is lane
    r of data thread w * 32 + l's slice q; a slice's aggregate is its
    last set lane, its prefix the aggregate of the nearest lower thread
    of its warp with a set lane, the warp's total that of its highest
    such thread; one exclusive max-scan of the Q * NW totals in slot
    order.  Every tile publishes its aggregate (tile 0 as inclusive),
    then looks back in `order` ("in_order", "reversed" or "random") and
    publishes its inclusive value.  Returns (out int32 [n], the most
    look-back steps a tile took)."""
    n = len(mask)
    ntiles = max(1, -(-n // TILE))
    pad = np.zeros(ntiles * TILE, bool)
    pad[:n] = mask
    st, tiles = [None] * ntiles, []
    for t in range(ntiles):
        m = pad[t * TILE:(t + 1) * TILE].reshape(Q, NW, 32, VEC)
        lanes = t * TILE + np.arange(TILE).reshape(Q, NW, 32, VEC)
        agg = np.where(m, lanes, -1).max(axis=3)          # [Q, NW, 32]
        pre = np.full_like(agg, -1)
        for lane in range(1, 32):
            below = agg[:, :, lane - 1]
            pre[:, :, lane] = np.where(below >= 0, below, pre[:, :, lane - 1])
        top = np.where(agg[:, :, 31] >= 0, agg[:, :, 31], pre[:, :, 31])
        tot = top.reshape(-1)
        excl = np.concatenate([[-1], np.maximum.accumulate(tot)[:-1]])
        tile_agg = int(tot.max())
        st[t] = ("I" if t == 0 else "A", tile_agg + 1)
        tiles.append((m, lanes, pre, excl.reshape(Q, NW), tile_agg))
    if order == "reversed":
        seq = range(ntiles - 1, -1, -1)
    elif order == "random":
        seq = np.random.default_rng(ntiles).permutation(ntiles)
    else:
        seq = range(ntiles)
    out, steps = np.empty(ntiles * TILE, np.int32), 0
    for t in seq:
        m, lanes, pre, excl, tile_agg = tiles[t]
        prefix = -1
        if t > 0:
            p, s = _look_back(st, t)
            prefix, steps = p - 1, max(steps, s)
            st[t] = ("I", max(prefix, tile_agg) + 1)
        cur = np.maximum(np.maximum(prefix, excl[:, :, None]), pre)
        o = np.empty((Q, NW, 32, VEC), np.int64)
        for r in range(VEC):
            cur = np.where(m[..., r], lanes[..., r], cur)
            o[..., r] = cur
        out[t * TILE:(t + 1) * TILE] = o.reshape(-1)
    return out[:n], steps


@pytest.mark.parametrize("order", ["in_order", "reversed", "random"])
@pytest.mark.parametrize("case", ["tile_plus_1", "tiles_7_ragged",
                                  "all_false", "density_0.001", "runs",
                                  "one_set_lane_last"])
def test_tile_model_matches_contract(case, order):
    mask = CASES[case]()
    got, _steps = tile_model(mask, order)
    np.testing.assert_array_equal(got, expected(mask))


def test_tile_model_looks_back_one_tile_where_dense():
    """In order, a tile's look-back stops at tile t - 1 in one step where
    every tile has a set lane; with none set it walks to tile 0, 32
    words a step."""
    assert tile_model(CASES["density_0.5"](), "in_order")[1] == 1
    mask = np.zeros(70 * TILE, bool)
    assert tile_model(mask, "reversed")[1] == 3


# -- the gate posts' two sites against their torch.cummax form ---------------

def _runs_cummax(bkeys):
    """countstep._runs as it was: each run's start by an int32 cummax."""
    n = bkeys.shape[0]
    newkey = torch.ones(n, dtype=torch.bool)
    newkey[1:] = bkeys[1:] != bkeys[:-1]
    ends = torch.cat([newkey[1:], newkey.new_ones(1)]) & (bkeys != INT64_MAX)
    lane = torch.arange(n, dtype=torch.int32)
    start = torch.cummax(torch.where(newkey, lane, 0), 0).values
    return ends, lane - start + 1


def _sorted_batch(case):
    rng = np.random.default_rng(len(case))
    n = {"one_lane": 1, "all_invalid": 5000}.get(case, 20000)
    keys = rng.integers(0, 3000, n).astype(np.int64) << 20
    valid = {"all_invalid": np.zeros(n, bool),
             "all_valid": np.ones(n, bool)}.get(case, rng.random(n) < 0.9)
    return torch.sort(torch.from_numpy(np.where(valid, keys, INT64_MAX)))[0]


@pytest.mark.parametrize("case", ["mixed", "all_valid", "one_lane",
                                  "all_invalid"])
def test_runs_match_cummax(case, monkeypatch):
    monkeypatch.setattr(scan, "last_set_lane", last_set_lane_scatter)
    bkeys = _sorted_batch(case)
    ends, mult = countstep._runs(bkeys)
    wends, wmult = _runs_cummax(bkeys)
    assert mult.dtype == torch.int32
    assert torch.equal(ends, wends) and torch.equal(mult, wmult)


def _bloom_insert_cummax(bf, h, active, *, pre, n_shift, n_hashes):
    """bloom_insert's plain gate as it was above DENSE_WORDS: each word
    run's start by an int64 cummax."""
    base, zs = bloom.probe_geom(h, pre=pre, n_shift=n_shift,
                                n_hashes=n_hashes)
    n_before = bloom.probe_count(bf, base, zs, active)
    nwords = bf.shape[0]
    pos = torch.stack([base + z for z in zs]).reshape(-1)
    act = active.repeat(len(zs))
    p = torch.sort(torch.where(act, pos, INT64_MAX)).values
    valid = p != INT64_MAX
    uniq = valid & (p != bloom._shift_in(p, -1))
    w = torch.where(valid, p >> 5, nwords)
    m = torch.where(uniq, torch.ones_like(p) << (p & 31), 0)
    csum0 = torch.cat([m.new_zeros(1), torch.cumsum(m, 0)])
    lane = torch.arange(p.shape[0], dtype=torch.int64)
    word_start = valid & (w != bloom._shift_in(w, -1))
    nxt = torch.cat([w[1:], w.new_full((1,), nwords)])
    word_end = valid & (w != nxt)
    start = torch.cummax(torch.where(word_start, lane, 0), 0).values
    run_mask = i32_bits(csum0[lane + 1] - csum0[start])
    idx = torch.where(word_end, w, 0)
    old = bf[idx]
    bf.scatter_add_(0, idx, torch.where(word_end, run_mask & ~old, 0))
    return bf, n_before, (idx, old)


@pytest.mark.parametrize("kernel", [True, False],
                         ids=["kernel_site", "library_site"])
@pytest.mark.parametrize("case", ["two_folds", "lane0_inactive",
                                  "none_active"])
def test_sparse_tail_matches_cummax(case, kernel, monkeypatch):
    """bloom_insert at -b28 (the sparse tail, in place) == its torch.cummax
    form over two inserts, in the filter, n_before and the undo record,
    and the undo gives back the filter before each insert: with
    `kernel`, scan.last_set_lane (swapped for the scatter version) finds
    the word runs' heads, else sorttable.last_set_lane."""
    monkeypatch.setattr(scan, "last_set_lane", last_set_lane_scatter)
    n_shift = 28
    assert (1 << (n_shift - 5)) > bloom.DENSE_WORDS
    rng = np.random.default_rng(len(case) + 31)
    space = rng.integers(0, 1 << 62, 3000, dtype=np.uint64)
    bf = bloom.make_bloom(n_shift, "cpu")
    want_bf = bf.clone()
    for _step in range(2):
        h = u64_to_torch(np.unique(rng.choice(space, 1500)))
        active = torch.from_numpy(rng.random(h.shape[0]) < 0.9)
        if case == "lane0_inactive":
            active[:3] = False
        elif case == "none_active":
            active[:] = False
        before = bf.clone()
        bf, n_before, (idx, old) = bloom.bloom_insert(
            bf, h, active, pre=PRE, n_shift=n_shift, n_hashes=N_HASH,
            kernel=kernel)
        want_bf, wn, (widx, wold) = _bloom_insert_cummax(
            want_bf, h, active, pre=PRE, n_shift=n_shift, n_hashes=N_HASH)
        assert torch.equal(n_before, wn) and torch.equal(bf, want_bf)
        assert torch.equal(idx, widx) and torch.equal(old, wold)
        assert (int(bf.ne(before).sum()) == 0) == (case == "none_active")
        after = bf.clone()
        assert torch.equal(bloom.rollback(bf, (idx, old)), before)
        bf.copy_(after)


# -- which paths call the kernel's function ---------------------------------

@pytest.fixture
def scan_calls(monkeypatch):
    """Every call of scan.last_set_lane, by mask size; the calls run the
    scatter version."""
    calls = []

    def record(mask):
        calls.append(mask.numel())
        return last_set_lane_scatter(mask)
    monkeypatch.setattr(scan, "last_set_lane", record)
    return calls


def _gate_geometry(seed, n=20000):
    rng = np.random.default_rng(seed)
    keys = u64_to_torch(rng.integers(0, 1 << 62, n // 4, dtype=np.uint64))
    keys = keys[torch.from_numpy(rng.integers(0, n // 4, n))]
    valid = torch.from_numpy(rng.random(n) < 0.9)
    return torch.where(valid, keys, INT64_MAX), valid


def test_plain_paths_call_no_kernel(scan_calls):
    """The sort-merge engines' merge and gate, dedup and the sorted join
    (the plain torch paths, the kernels' mirrors) never call
    scan.last_set_lane, at the sparse tail's geometry too."""
    keys, valid = _gate_geometry(1)
    cap = 1 << 15
    tkeys = torch.full((cap,), INT64_MAX, dtype=torch.int64)
    tcnt = torch.zeros(cap, dtype=torch.int32)
    size = torch.zeros((), dtype=torch.int32)
    add = torch.ones(keys.shape, dtype=torch.int32)
    okeys, ocnt, size2, _n_new, _ovf = st.merge_batch(
        tkeys, tcnt, size, keys, add, valid, True)
    st.lookup(okeys, ocnt, size2, keys)
    st.dedup(keys, with_rank=True)
    for exact in (False, True):
        bf = bloom.make_bloom(28, "cpu")
        countstep.gate_batch(keys, bf, PRE, 28, N_HASH, exact)
    assert scan_calls == []


@pytest.mark.parametrize("post", ["plain", "exact", "sentinel"])
def test_default_posts_call_the_kernel(post, scan_calls):
    """The default engine's gate posts find their key runs' heads by
    scan.last_set_lane, and the plain and exact posts their sparse
    tail's word runs' too (4 probe lanes a key at -b28)."""
    keys, _valid = _gate_geometry(2)
    bkeys, perm = torch.sort(keys, stable=True)
    n_shift = 28 if post != "sentinel" else 20
    bf = bloom.make_bloom(n_shift, "cpu")
    if post == "plain":
        countstep.bloom_gate_post(bkeys, bf, PRE, n_shift, N_HASH)
    elif post == "exact":
        countstep.bloom_gate_exact_post(bkeys, perm, bf, PRE, n_shift, N_HASH)
    else:
        countstep.bloom_gate_sentinel_post(bkeys, bf, PRE, n_shift, N_HASH)
    n = keys.numel()
    assert scan_calls == ([n] if post == "sentinel" else [n, N_HASH * n])


# -- on the card -------------------------------------------------------------

def _on_card(mask, dev):
    """(the kernel's answer, torch.cummax's) on the card."""
    m = torch.from_numpy(mask).to(dev)
    lane = torch.arange(m.numel(), dtype=torch.int32, device=dev)
    want = torch.cummax(torch.where(m, lane, -1), 0).values
    return scan.last_set_lane(m), want


def test_kernel_tile_on_card(cuda_device):
    """The kernel's tile is the one the model above decomposes."""
    assert scan._library().yak_last_set_lane_tile() == TILE


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_cummax_on_card(cuda_device, case):
    """The kernel == torch.cummax of the set lanes on the card, one launch
    a call."""
    launches = scan.last_set_lane.launches
    got, want = _on_card(CASES[case](), cuda_device)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert scan.last_set_lane.launches == launches + 1


def test_kernel_matches_cummax_at_84m_on_card(cuda_device):
    """One mask of 84 M lanes (the -b37 sparse tail's scale)."""
    got, want = _on_card(_density(84_000_000, 0.6, 11, lane0=False),
                         cuda_device)
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [1, 2, 3, 4])
def test_kernel_unaligned_and_uint8_on_card(cuda_device, offset):
    """A mask that starts off a 4-byte boundary (a view), and uint8 masks
    with set bytes other than 1."""
    mask = _density(3 * TILE + 11, 0.4, 12 + offset)
    m = torch.from_numpy(mask).to(cuda_device)
    for view in (m[offset:], (m.to(torch.uint8) * (1 + offset))[offset:]):
        np.testing.assert_array_equal(scan.last_set_lane(view).cpu().numpy(),
                                      expected(mask[offset:]))
    assert scan.last_set_lane(m[:0]).numel() == 0


def test_gate_post_sparse_tail_on_card(cuda_device):
    """The plain gate post at -b28 (the sparse tail, kernel's scan at both
    sites) on the card == the CPU's, in weights, filter and undo record,
    over two folds, and a rollback gives back the first fold's filter."""
    n_shift = 28
    rng = np.random.default_rng(28)
    space = rng.integers(0, 1 << 62, 150000, dtype=np.uint64)
    bfs = {d: bloom.make_bloom(n_shift, d) for d in ("cpu", cuda_device)}
    launches = scan.last_set_lane.launches
    for _fold in range(2):
        batch = rng.choice(space, size=200000)
        valid = rng.random(batch.shape[0]) < 0.95
        bkeys = countstep.sort_batch(u64_to_torch(batch),
                                     torch.from_numpy(valid), False)
        kept = bfs["cpu"].clone()
        out = {}
        for d in bfs:
            w, bfs[d], undo = countstep.bloom_gate_post(
                bkeys.to(d), bfs[d], PRE, n_shift, N_HASH)
            out[d] = (w, undo)
        (w, (idx, old)), (cw, (cidx, cold)) = out["cpu"], out[cuda_device]
        assert int((w > 0).sum()) > 1000
        assert torch.equal(cw.cpu(), w)
        assert torch.equal(bfs[cuda_device].cpu(), bfs["cpu"])
        assert torch.equal(cidx.cpu(), idx) and torch.equal(cold.cpu(), old)
    assert scan.last_set_lane.launches == launches + 4
    back = bloom.rollback(bfs[cuda_device], (cidx, cold))
    assert torch.equal(back.cpu(), kept)


def test_sort_merge_gate_launches_nothing_on_card(cuda_device):
    """The sort-merge engines' gate at -b28 on the card (library calls
    alone: the "xla" engine launches no kernel) == the CPU's."""
    keys, _valid = _gate_geometry(3, 200000)
    launches = scan.last_set_lane.launches
    out = {}
    for d in ("cpu", cuda_device):
        bf = bloom.make_bloom(28, d)
        out[d] = countstep.gate_batch(keys.to(d), bf, PRE, 28, N_HASH, False)
    torch.cuda.synchronize()
    assert scan.last_set_lane.launches == launches
    for a, b in zip(out["cpu"][:3] + out["cpu"][4], out[cuda_device][:3]
                    + out[cuda_device][4]):
        assert torch.equal(a, b.cpu())
    assert torch.equal(out["cpu"][3], out[cuda_device][3].cpu())
