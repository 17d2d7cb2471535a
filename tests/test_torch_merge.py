"""The port's merge-reduce (ops/merge.py, plain torch version on the CPU)
and its sort-merge engine (ops/sorttable.merge_batch) against the JAX
package's Pallas merge-reduce kernel in interpret mode and its XLA
merge_batch.  Every value is an integer: all comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_merge_cases import CASES, expected, sorted_table
from yak_tpu.ops import sorttable as jst
from yak_tpu.ops.countstep import _pmerge_prep_impl, finalize_pmerge
from yak_tpu.ops.pallas_merge import merge_reduce as pallas_merge_reduce
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
