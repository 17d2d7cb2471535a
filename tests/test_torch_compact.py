"""The port's stream compaction (ops/compact.compact, plain torch version
on the CPU) against the JAX package's Pallas compaction kernel
(pallas_compact.compact_u32, interpret mode) and its NumPy oracle
(compact_reference).  Every value is an integer: all comparisons are
exact on the kept lanes (the tail is unspecified in both)."""

import numpy as np
import pytest
import torch

from torch_compact_cases import CASES, as_int32, expected
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


def test_compact_kernel_matches_plain_on_card(cuda_device):
    """On a CUDA card: the hand-written compaction equals the plain
    version on every case, and each call counts one launch."""
    for name, (build, _pallas) in CASES.items():
        planes, _ = _port(*build(), device=cuda_device)
        before = compact.compact.launches
        got = compact.compact(*planes)
        assert compact.compact.launches == before + 1
        want = compact.compact_plain(*planes)
        torch.cuda.synchronize()
        m = int(want[3])
        assert int(got[3]) == m, name
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g[:m], w[:m]), name
