"""The port's merge-reduce (ops/merge.py, plain torch version on the CPU)
and its sort-merge engine (ops/sorttable.merge_batch) against the JAX
package's Pallas merge-reduce kernel in interpret mode and its XLA
merge_batch, in count mode and in the weighted (Bloom-gated) and wide
(k >= 32) modes; and a numpy model of the CUDA kernel's tile
decomposition (segmented aggregates, look-back carries, survivor
offsets) against the numpy contract.  Every value is an integer: all
comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_merge_cases import (CASES, CUDA_TILE, MODE_CASES, SIGN, expected,
                               sorted_batch, sorted_table)
from yak_tpu.ops import sorttable as jst
from yak_tpu.ops.countstep import (_pmerge_prep_impl, _xs_packed_sorted,
                                   _xs_wide_sorted, finalize_pmerge)
from yak_tpu.ops.pallas_merge import merge_reduce as pallas_merge_reduce
from yak_tpu.ops.pallas_merge import merge_reduce_presorted
from yak_tpu_torch.ops import merge, sorttable
from yak_tpu_torch.ops.countstep import sort_batch
from yak_tpu_torch.ops.keys import torch_to_u64, u64_to_torch


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs; skips where there is none
    (a CUDA kernel has no CPU mode; chip_smoke.py runs the same check
    on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card for the hand-written kernel")
    return torch.device("cuda")


def _port_inputs(tk, tc, n, batch, valid, device="cpu"):
    tkeys = u64_to_torch(tk, device)
    tcnt = torch.from_numpy(tc).to(device)
    size = torch.tensor(n, dtype=torch.int32, device=device)
    h = u64_to_torch(batch, device)
    v = torch.from_numpy(valid).to(device)
    return tkeys, tcnt, size, h, v


def _live(keys, cnt, size, cap):
    n = min(int(size), cap)
    return np.asarray(keys)[:n].astype(np.uint64), np.asarray(cnt)[:n]


def _jax_results(tk, tc, n, batch, valid, cap, create, pallas):
    adds = np.ones(len(batch), np.int32)

    def args():   # merge_batch donates the table arrays: fresh each call
        return (jnp.asarray(tk), jnp.asarray(tc), jnp.int32(n),
                jnp.asarray(batch), jnp.asarray(adds), jnp.asarray(valid))

    out = {"xla": jst.merge_batch(*args(), mode=jst.ADD, create=create,
                                  packable=True)}
    if pallas:
        prep = _pmerge_prep_impl(*args())
        pm = pallas_merge_reduce(*prep, Na=cap, Nb=len(batch),
                                 create=create, interpret=True)
        out["pallas"] = finalize_pmerge(*pm, cap=cap)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_merge_matches_jax(name):
    build, pallas = CASES[name]
    hs, cs, batch, valid, cap, create = build()
    tk, tc = sorted_table(hs, cs, cap)
    n = len(hs)
    tkeys, tcnt, size, h, v = _port_inputs(tk, tc, n, batch, valid)

    okeys, ocnt, new_size, n_new = merge.merge_reduce(
        tkeys, tcnt, size, sort_batch(h, v), create)
    port_ovf = int(new_size) > cap
    port = (torch_to_u64(okeys), ocnt.numpy(), int(new_size), int(n_new))
    sk, sc, ssize, snew, sovf = sorttable.merge_batch(
        tkeys, tcnt, size, h, torch.ones(len(batch), dtype=torch.int32), v,
        create=create)

    want_k, want_c, want_size, want_new = expected(hs, cs, batch, valid,
                                                   cap, create)
    assert port[2] == want_size and port[3] == want_new
    np.testing.assert_array_equal(port[0][:len(want_k)], want_k)
    np.testing.assert_array_equal(port[1][:len(want_k)], want_c)

    for ref_name, (rk, rc, rsize, rnew, rovf) in _jax_results(
            tk, tc, n, batch, valid, cap, create, pallas).items():
        assert bool(rovf) == port_ovf == bool(sovf), ref_name
        assert int(rsize) == min(port[2], cap) == int(ssize), ref_name
        assert int(rnew) == port[3] == int(snew), ref_name
        want_keys, want_cnt = _live(rk, rc, rsize, cap)
        for got_keys, got_cnt in ((port[0], port[1]),
                                  (torch_to_u64(sk), sc.numpy())):
            np.testing.assert_array_equal(got_keys[:len(want_keys)],
                                          want_keys)
            np.testing.assert_array_equal(got_cnt[:len(want_cnt)], want_cnt)


def _mode_port_args(case, device="cpu"):
    """(tkeys, tcnt, size, bkeys, create, weights, wide) of a MODE_CASES
    case as the count path hands them to merge_reduce."""
    hs, cs, batch, valid, w, cap, create, wide = case
    tk, tc = sorted_table(hs, cs, cap, wide)
    bkeys, bw = sorted_batch(batch, valid, w, wide)
    return (u64_to_torch(tk, device), torch.from_numpy(tc).to(device),
            torch.tensor(len(hs), dtype=torch.int32, device=device),
            torch.from_numpy(bkeys).to(device), create,
            None if bw is None else torch.from_numpy(bw).to(device), wide)


def _pallas_mode_merge(hs, cs, batch, valid, w, cap, create, wide):
    """The JAX package's presorted fold on the same inputs: the XLA-sorted
    descending planes (_xs_packed_sorted, or _xs_wide_sorted with the
    kernel's clamp), each key run's weight sum on the run's last lane of
    the `bw` plane, the Pallas kernel in interpret mode."""
    tk, tc = sorted_table(hs, cs, cap)
    Ehi, Elo = (_xs_wide_sorted if wide else _xs_packed_sorted)(
        jnp.asarray(batch), jnp.asarray(valid))
    bw = None
    if w is not None:
        E = ((np.asarray(Ehi).astype(np.uint64) << np.uint64(32))
             | np.asarray(Elo).astype(np.uint64))
        key = E if wide else E >> np.uint64(1)
        tot = {}
        for x, wx in zip(sorted_batch(batch, valid, wide=wide)[0].tolist(),
                         sorted_batch(batch, valid, w, wide)[1].tolist()):
            tot[x] = tot.get(x, 0) + wx
        enc = (key ^ SIGN if wide else key).view(np.int64)
        ends = (E != np.uint64((1 << 64) - 1)) & np.append(E[:-1] != E[1:],
                                                           True)
        bwn = np.zeros(len(E), np.int32)
        bwn[ends] = [tot[x] for x in enc[ends].tolist()]
        bw = jnp.asarray(bwn)
    shifted = jnp.asarray(tk) if wide else jnp.asarray(tk) << jnp.uint64(1)
    thi = (shifted >> jnp.uint64(32)).astype(jnp.uint32)
    tlo = (shifted & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    out = merge_reduce_presorted(
        jnp.full((1,), len(hs), jnp.int32), thi, tlo, jnp.asarray(tc), Ehi,
        Elo, bw=bw, Na=cap, Nb=len(batch), create=create, interpret=True,
        wide=wide)
    return finalize_pmerge(*out, cap=cap, wide=wide)


@pytest.mark.parametrize("name", list(MODE_CASES))
def test_mode_merge_matches_jax(name):
    """Weighted and wide modes: the port's merge_reduce (the plain
    version on the CPU) == the numpy contract == the Pallas kernel's
    presorted fold in interpret mode == the XLA merge_batch with the
    zero-weight lanes invalid (not for the clamp cases: the XLA engine
    does not clamp 0xFF..FF)."""
    case = MODE_CASES[name]()
    hs, cs, batch, valid, w, cap, create, wide = case
    tkeys, tcnt, size, bkeys, _, bw, _ = _mode_port_args(case)
    okeys, ocnt, new_size, n_new = merge.merge_reduce(
        tkeys, tcnt, size, bkeys, create, weights=bw, wide=wide)
    keys = torch_to_u64(okeys) ^ (SIGN if wide else np.uint64(0))
    want_k, want_c, want_size, want_new = expected(*case[:4], cap, create,
                                                   w, wide)
    assert int(new_size) == want_size and int(n_new) == want_new
    n = min(want_size, cap)
    np.testing.assert_array_equal(keys[:n], want_k)
    np.testing.assert_array_equal(ocnt.numpy()[:n], want_c)

    refs = {"pallas": _pallas_mode_merge(*case)}
    if "clamp" not in name:
        add = np.ones(len(batch), np.int32) if w is None else w
        refs["xla"] = jst.merge_batch(
            *(jnp.asarray(a) for a in sorted_table(hs, cs, cap)),
            jnp.int32(len(hs)), jnp.asarray(batch), jnp.asarray(add),
            jnp.asarray(valid & (add > 0)), mode=jst.ADD, create=create,
            packable=not wide)
    for ref_name, (rk, rc, rsize, rnew, rovf) in refs.items():
        assert int(rsize) == n and int(rnew) == want_new, ref_name
        assert bool(rovf) == (want_size > cap), ref_name
        np.testing.assert_array_equal(np.asarray(rk)[:n], want_k)
        np.testing.assert_array_equal(np.asarray(rc)[:n], want_c)


def test_merge_rejects_bad_inputs():
    keys = torch.zeros(16, dtype=torch.int64)
    cnt = torch.zeros(16, dtype=torch.int32)
    size = torch.zeros((), dtype=torch.int32)
    b = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(TypeError):
        merge.merge_reduce(keys, cnt.to(torch.int64), size, b)
    with pytest.raises(ValueError):
        merge.merge_reduce(keys, cnt, size, b[::2])
    with pytest.raises(ValueError):
        merge.merge_reduce(keys, cnt[:8], size, b)
    with pytest.raises(TypeError):
        merge.merge_reduce(keys, cnt, size, b, weights=b)
    with pytest.raises(ValueError):
        merge.merge_reduce(keys, cnt, size, b,
                           weights=torch.zeros(4, dtype=torch.int32))


def test_merge_kernel_matches_plain_on_card(cuda_device):
    """On a CUDA card: the hand-written kernel equals the plain version
    on every case, and each call counts one launch."""
    for name, (build, _pallas) in CASES.items():
        hs, cs, batch, valid, cap, create = build()
        tk, tc = sorted_table(hs, cs, cap)
        args = _port_inputs(tk, tc, len(hs), batch, valid, cuda_device)
        bkeys = sort_batch(args[3], args[4])
        before = merge.merge_reduce.launches
        ok, oc, ns, nn = merge.merge_reduce(*args[:3], bkeys, create)
        assert merge.merge_reduce.launches == before + 1
        pk, pc, ps, pn = merge.merge_reduce_plain(*args[:3], bkeys, create)
        torch.cuda.synchronize()
        live = min(int(ps), cap)
        assert int(ns) == int(ps) and int(nn) == int(pn), name
        assert torch.equal(ok[:live], pk[:live]), name
        assert torch.equal(oc[:live], pc[:live]), name


def test_mode_merge_kernel_matches_plain_on_card(cuda_device):
    """On a CUDA card: the weighted and wide modes of the kernel equal
    the plain version on every mode case, and each launch counts in
    its modes."""
    for name, build in MODE_CASES.items():
        tkeys, tcnt, size, bkeys, create, bw, wide = _mode_port_args(
            build(), cuda_device)
        modes = dict(merge.merge_reduce.mode_launches)
        ok, oc, ns, nn = merge.merge_reduce(tkeys, tcnt, size, bkeys, create,
                                            weights=bw, wide=wide)
        after = merge.merge_reduce.mode_launches
        assert after["weighted"] == modes["weighted"] + (bw is not None)
        assert after["wide"] == modes["wide"] + wide
        pk, pc, ps, pn = merge.merge_reduce_plain(tkeys, tcnt, size, bkeys,
                                                  create, bw)
        torch.cuda.synchronize()
        live = min(int(ps), tkeys.numel())
        assert int(ns) == int(ps) and int(nn) == int(pn), name
        assert torch.equal(ok[:live], pk[:live]), name
        assert torch.equal(oc[:live], pc[:live]), name


SAT = 1 << 30          # the kernel's run sums saturate here
INT64_MAX = (1 << 63) - 1


def _seg_combine(a, b):
    """Segmented aggregates (f, s, p), a earlier: b's head fixes s, p."""
    if b[0]:
        return b
    return a[0], min(a[1] + b[1], SAT), a[2] | b[2]


def tile_model(tkeys, tcnt, size, bkeys, weights, create):
    """The merge-reduce as csrc/merge_reduce.cu decomposes it, in numpy:
    the merged stream (live table lanes first on equal keys, the batch's
    INT64_MAX tail merged as ordinary lanes) cut into CUDA_TILE-lane
    tiles; each tile's segmented aggregate from its own lanes; its carry
    from earlier tiles' aggregates in look-back order (nearest first,
    combined earlier (+) later, stopping at the first tile with a head);
    its exact survivor count with the continued run's fate from the
    carry; offsets, new_size and n_new from the counts.  A tile whose
    first lane is invalid ends the stream.  Returns (keys, counts,
    new_size, n_new) with keys and counts cut at the table's capacity."""
    cap = len(tkeys)
    keys = np.concatenate([tkeys[:size], bkeys])
    vals = np.concatenate([tcnt[:size].astype(np.int64),
                           np.ones(len(bkeys), np.int64) if weights is None
                           else weights.astype(np.int64)])
    tab = np.arange(len(keys)) < size
    order = np.argsort(keys, kind="stable")   # table lanes come first
    keys, vals, tab = keys[order], vals[order], tab[order]
    n = len(keys)
    valid = keys != INT64_MAX
    head = valid & np.append(True, keys[1:] != keys[:-1])
    end = valid & np.append(keys[1:] != keys[:-1], True)

    aggs, out_k, out_c, new_size, n_new = [], [], [], 0, 0
    for d0 in range(0, n, CUDA_TILE):
        sl = slice(d0, min(d0 + CUDA_TILE, n))
        if not valid[d0]:
            assert not valid[d0:].any()
            break
        h, e, v, p, k = head[sl], end[sl], vals[sl], tab[sl], keys[sl]
        seg = np.cumsum(h)            # 0: the run continued into the tile
        s_seg = np.minimum(np.bincount(seg, weights=v * valid[sl]), SAT)
        p_seg = np.bincount(seg, weights=p) > 0
        last = seg[-1]
        agg = (bool(h.any()), int(s_seg[last]), bool(p_seg[last]))
        carry = (False, 0, False)
        for j in range(len(aggs) - 1, -1, -1):
            carry = _seg_combine(aggs[j], carry)
            if aggs[j][0]:
                break
        aggs.append(agg)
        count = made = 0
        for i in np.nonzero(e)[0]:
            run = (True, int(s_seg[seg[i]]), bool(p_seg[seg[i]]))
            if seg[i] == 0:
                run = _seg_combine(carry, (False,) + run[1:])
            if weights is None:
                keep = bool(create) or run[2]
            else:
                keep = (run[2] or run[1] > 0) if create else run[2]
            if keep:
                count += 1
                made += not run[2]
                out_k.append(k[i])
                out_c.append(min(run[1], 1023))
        new_size += count
        n_new += made
    return (np.array(out_k, np.int64)[:cap], np.array(out_c, np.int32)[:cap],
            new_size, n_new)


@pytest.mark.parametrize("name", list(CASES) + list(MODE_CASES))
def test_tile_model_matches_contract(name):
    """The kernel's tile decomposition, carries and offsets (numpy model)
    == the numpy contract, on every count-mode and mode case."""
    if name in CASES:
        hs, cs, batch, valid, cap, create = CASES[name][0]()
        w, wide = None, False
    else:
        hs, cs, batch, valid, w, cap, create, wide = MODE_CASES[name]()
    tk, tc = sorted_table(hs, cs, cap, wide)
    bkeys, bw = sorted_batch(batch, valid, w, wide)
    got_k, got_c, got_size, got_new = tile_model(
        tk.view(np.int64), tc, len(hs), bkeys, bw, create)
    want_k, want_c, want_size, want_new = expected(hs, cs, batch, valid, cap,
                                                   create, w, wide)
    assert got_size == want_size and got_new == want_new
    keys = got_k.view(np.uint64) ^ (SIGN if wide else np.uint64(0))
    np.testing.assert_array_equal(keys, want_k)
    np.testing.assert_array_equal(got_c, want_c)
