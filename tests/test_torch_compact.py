"""The port's stream compaction (ops/compact.compact, plain torch version
on the CPU) against the JAX package's Pallas compaction kernel
(pallas_compact.compact_u32, interpret mode) and its NumPy oracle
(compact_reference); and a numpy model of the CUDA kernel's tile
decomposition (tile_model) against the contract.  Every value is an
integer: all comparisons are exact on the kept lanes (the tail is
unspecified in both)."""

import numpy as np
import pytest
import torch

from torch_compact_cases import (CASES, CUDA_NT, CUDA_Q, CUDA_TILE, CUDA_VEC,
                                 as_int32, expected, offset_planes)
from yak_tpu.ops import pallas_compact as pc
from yak_tpu_torch.ops import compact


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs; skips where there is none
    (a CUDA kernel has no CPU mode; chip_smoke.py runs the same check
    on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card for the hand-written kernel")
    return torch.device("cuda")


def _port(khi, klo, v, device="cpu"):
    planes = [torch.from_numpy(as_int32(a)).to(device) for a in (khi, klo, v)]
    return planes, compact.compact(*planes)


@pytest.mark.parametrize("name", list(CASES))
def test_compact_matches_jax(name):
    build, pallas = CASES[name]
    khi, klo, v = build()
    _, (ohi, olo, ov, n_kept) = _port(khi, klo, v)
    m = int(n_kept)
    got = [as_int32(o.numpy()[:m]) for o in (ohi, olo, ov)]
    whi, wlo, wv, wm = expected(khi, klo, v)
    assert m == wm
    for g, w in zip(got, (whi, wlo, wv)):
        np.testing.assert_array_equal(g, as_int32(w))
    rhi, rlo, rv, rm = pc.compact_reference(khi, klo, v)
    assert rm == m
    for g, w in zip(got, (rhi, rlo, rv)):
        np.testing.assert_array_equal(g, as_int32(w[:m]))
    if pallas:
        jout = pc.compact_u32(khi, klo, v, interpret=True)
        for g, w in zip(got, jout):
            np.testing.assert_array_equal(g, as_int32(np.asarray(w)[:m]))


def test_compact_order_and_count():
    """Kept lanes keep their input order; n_kept is an int32 scalar."""
    khi, klo, v = CASES["order_preserved"][0]()
    _, (ohi, _olo, ov, n_kept) = _port(khi, klo, v)
    m = int(n_kept)
    assert n_kept.dtype == torch.int32 and n_kept.dim() == 0
    assert (np.diff(ohi.numpy()[:m].astype(np.int64)) > 0).all()
    np.testing.assert_array_equal(ov.numpy()[:m],
                                  np.arange(len(khi))[khi < (1 << 31)])


def test_compact_rejects_bad_inputs():
    a = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        compact.compact(a.to(torch.int64), a, a)
    with pytest.raises(ValueError):
        compact.compact(a, a[:4], a)
    with pytest.raises(ValueError):
        compact.compact(a, a[::2], a[::2])


def test_compact_rejects_too_many_lanes():
    """n_kept is int32, so n must be below 2^31 (meta tensors: no
    memory)."""
    a = torch.empty(1 << 31, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="2\\^31"):
        compact.compact(a, a, a)


NT, Q, VEC = CUDA_NT, CUDA_Q, CUDA_VEC
NW = NT // 32


def tile_grid(ptr, n):
    """(head, ntiles) of the kernel's tiles over khi at device address
    `ptr` with n lanes: tiles are cut from the 16-byte boundary at or
    below ptr, which lies `head` lanes before khi's first; a call runs at
    least one tile (it writes n_kept)."""
    head = (ptr >> 2) & 3
    return head, max(1, -(-(n + head) // CUDA_TILE))


def _look_back(st, t):
    """The kernel's look_back over status words st ((flag, value), flag
    "A" = the tile's own count, "I" = inclusive, None = unpublished):
    32 words a step, nearest first; a step whose words up to the
    nearest inclusive one are not all published would wait.  Returns
    (offset, steps)."""
    acc, j, steps = 0, t - 1, 0
    while True:
        steps += 1
        w = [st[j - lane] if j - lane >= 0 else None for lane in range(32)]
        inc = [lane for lane in range(32) if w[lane] and w[lane][0] == "I"]
        first = inc[0] if inc else 31
        assert all(w[lane] for lane in range(first + 1)), "would wait"
        acc += sum(w[lane][1] for lane in range(first + 1))
        if inc:
            return acc, steps
        j -= 32


def tile_model(khi, klo, v, ptr, order):
    """The compaction as csrc/compact.cu decomposes it, in numpy: khi
    (uint32, at device address `ptr`) cut into CUDA_TILE-lane tiles from
    the 16-byte boundary at or below ptr (tile_grid), lanes
    outside [0, n) dropped; slot s = ((q * NW + w) * 32 + l) * VEC + r
    of a tile is lane r of data thread w * 32 + l's load q; ranks from
    the ballot-spread thread counts, the warp prefixes and one scan of
    the Q * NW (load, warp) totals; offsets by look-back with the tiles
    looking back in `order` ("in_order", "reversed" or "random": tile 0
    publishes inclusive at once, each other tile its count, then its
    inclusive count after its look-back); the last tile's inclusive count
    is n_kept.  Returns (ohi, olo, ov cut at n_kept, n_kept, the most
    look-back steps a tile took)."""
    n = len(khi)
    head, ntiles = tile_grid(ptr, n)
    assert ntiles * CUDA_TILE >= n + head   # the tiles cover [0, n)
    assert ntiles == 1 or (ntiles - 1) * CUDA_TILE < n + head
    kept = np.zeros(ntiles * CUDA_TILE, bool)
    kept[head:head + n] = khi < (1 << 31)
    flags = kept.reshape(ntiles, Q, NW, 32, VEC)
    c = flags.sum(-1)                                   # per thread a load
    bits = [(c >> b) & 1 for b in range(3)]             # the three ballots
    pre = sum((np.cumsum(bb, -1) - bb) << b for b, bb in enumerate(bits))
    wsum = sum(bb.sum(-1) << b for b, bb in enumerate(bits))   # [t, q, w]
    wsum = wsum.reshape(ntiles, Q * NW)                 # index q * NW + w
    wex = (np.cumsum(wsum, -1) - wsum).reshape(ntiles, Q, NW, 1, 1)
    rank = wex + pre[..., None] + np.cumsum(flags, -1) - flags
    count = wsum.sum(-1)
    for t in range(ntiles):   # ranks: the kept slots' order, from 0
        np.testing.assert_array_equal(rank[t][flags[t]],
                                      np.arange(count[t]))

    st = [("A", int(cnt)) for cnt in count]
    st[0] = ("I", int(count[0]))
    off = [0] * ntiles
    tiles = list(range(1, ntiles))
    if order == "reversed":
        tiles.reverse()
    elif order == "random":
        np.random.default_rng(ntiles).shuffle(tiles)
    steps = 0
    for t in tiles:
        off[t], s = _look_back(st, t)
        steps = max(steps, s)
        st[t] = ("I", off[t] + int(count[t]))
    n_kept = st[-1][1]

    planes = [np.zeros(n_kept, a.dtype) for a in (khi, klo, v)]
    rank = rank.reshape(ntiles, CUDA_TILE)
    for t in range(ntiles):
        slots = np.flatnonzero(kept[t * CUDA_TILE:(t + 1) * CUDA_TILE])
        lanes = t * CUDA_TILE + slots - head
        for o, a in zip(planes, (khi, klo, v)):
            o[off[t] + rank[t][slots]] = a[lanes]
    return planes[0], planes[1], planes[2], n_kept, steps


@pytest.mark.parametrize("order", ["in_order", "reversed", "random"])
@pytest.mark.parametrize("name", list(CASES))
def test_tile_model_matches_contract(name, order):
    """The kernel's tile decomposition, ranks, look-back offsets and
    n_kept (numpy model) == the contract, at each of the four 4-byte
    offsets from a 16-byte boundary, with the tiles' look-backs in order,
    reversed and shuffled."""
    khi, klo, v = CASES[name][0]()
    whi, wlo, wv, wm = expected(khi, klo, v)
    for head in range(4):
        ohi, olo, ov, m, steps = tile_model(khi, klo, v, 1024 + 4 * head,
                                            order)
        assert m == wm
        for g, w in zip((ohi, olo, ov), (whi, wlo, wv)):
            np.testing.assert_array_equal(g, w)
        if order == "reversed" and len(khi) + head > 33 * CUDA_TILE:
            assert steps > 1   # a look-back crossed its first 32-word step


def test_compact_kernel_matches_plain_on_card(cuda_device):
    """On a CUDA card: the kernel's tile is the fixtures' CUDA_TILE; the
    hand-written compaction equals the plain version on every case, with
    the planes at each 4-byte offset from a 16-byte boundary and with klo
    the same tensor as khi (as both callers pass it), and each call
    counts one launch; the kernel's scratch is one word more than
    tile_grid's tiles."""
    lib = compact._library()
    assert lib.yak_compact_tile() == CUDA_TILE
    for ptr in (4096, 4100, 4104, 4108):
        for n in (0, 1, 3, CUDA_TILE - 1, CUDA_TILE, CUDA_TILE + 1,
                  5 * CUDA_TILE - 2):
            assert (lib.yak_compact_scratch_words(ptr, n)
                    == 1 + tile_grid(ptr, n)[1])
    for name, (build, _pallas) in CASES.items():
        arrays = build()
        for offset in range(4):
            khi, klo, v = offset_planes(arrays, cuda_device, offset)
            for planes in ((khi, klo, v), (khi, khi, v)):
                before = compact.compact.launches
                got = compact.compact(*planes)
                assert compact.compact.launches == before + 1
                want = compact.compact_plain(*planes)
                torch.cuda.synchronize()
                m = int(want[3])
                assert int(got[3]) == m, name
                for g, w in zip(got[:3], want[:3]):
                    assert torch.equal(g[:m], w[:m]), name
