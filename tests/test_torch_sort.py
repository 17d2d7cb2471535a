"""The psort engine's sort (ops/sort.sort, plain torch version on the
CPU) against the JAX package's Pallas bitonic sort (pallas_sort.
sort_planes and sort_planes32 in interpret mode, with windows smaller
than the batch so that the cross-window exchange passes run, as
tests/test_pallas_sort.py runs them) and against numpy's lexsort on
ragged lengths, duplicates and the extremes of the key types.  The
radix kernel's plan (ops/sort.plan_plain: which digit passes run, in
which order) is checked on the CPU by its pass counts on the radix cases
and by running it as a numpy model of the kernel's stable digit passes
against lexsort on every case.  Every value is an integer: all
comparisons are exact.

The port sorts signed int64/int32 keys; the JAX package sorts u64 keys
as hi/lo u32 planes and u32 keys.  `^ (1 << 63)` (`^ (1 << 31)`) maps
one order onto the other; `neg_keys` outputs are complemented back
before the compare.  Keys are distinct in the cases against the Pallas
sort, so the payload order is fixed there (the TPU network leaves the
order of equal keys unspecified).
"""

import numpy as np
import pytest
import torch

from torch_sort_cases import CASES, RADIX_PASSES, expected
from yak_tpu.ops import pallas_sort
from yak_tpu_torch.ops import sort

SIGN64, SIGN32 = np.uint64(1 << 63), np.uint32(1 << 31)


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs; skips where there is none
    (a CUDA kernel has no CPU mode; chip_smoke.py runs the same check
    on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card for the hand-written kernel")
    return torch.device("cuda")


def _port(keys, payload, device="cpu"):
    k = torch.from_numpy(keys).to(device)
    p = None if payload is None else torch.from_numpy(payload).to(device)
    return k, p


@pytest.mark.parametrize("B,neg,with_pay", [
    (1024, False, True), (4096, False, True), (16384, False, True),
    (1024, True, True), (4096, True, True), (16384, True, True),
    (4096, False, False)])
def test_plain_matches_pallas_u64(B, neg, with_pay):
    rng = np.random.default_rng(B + 2 * neg + with_pay)
    # distinct u64 keys over the whole range, half of them >= 2^63
    keys = np.unique(rng.integers(0, 1 << 62, B + 64, dtype=np.int64))
    keys = rng.permutation(keys)[:B].astype(np.uint64) * np.uint64(4) + \
        np.uint64(1)
    keys[rng.random(B) < 0.5] |= SIGN64
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    lo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    pay = rng.integers(-(1 << 31), 1 << 31, B, dtype=np.int32)
    extra = (pay,) if with_pay else ()
    out = pallas_sort.sort_planes(hi, lo, *extra, neg_keys=neg, window=1024,
                                  interpret=True)
    shi, slo = (np.asarray(o) for o in out[:2])
    if neg:
        shi, slo = ~shi, ~slo
    want = (shi.astype(np.uint64) << np.uint64(32)) | slo
    got_k, got_p = sort.sort(*_port((keys ^ SIGN64).view(np.int64),
                                    pay if with_pay else None))
    np.testing.assert_array_equal(got_k.numpy().view(np.uint64) ^ SIGN64,
                                  want)
    if with_pay:
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(out[2]))
    else:
        assert got_p is None


@pytest.mark.parametrize("B,neg,with_pay", [
    (1024, False, True), (4096, False, True), (16384, False, True),
    (4096, True, True), (4096, False, False)])
def test_plain_matches_pallas_u32(B, neg, with_pay):
    rng = np.random.default_rng(7 * B + 2 * neg + with_pay)
    key = rng.choice(1 << 32, B, replace=False).astype(np.uint32)
    pay = rng.integers(-(1 << 31), 1 << 31, B, dtype=np.int32)
    extra = (pay,) if with_pay else ()
    out = pallas_sort.sort_planes32(key, *extra, neg_keys=neg, window=1024,
                                    interpret=True)
    want = np.asarray(out[0])
    if neg:
        want = ~want
    got_k, got_p = sort.sort(*_port((key ^ SIGN32).view(np.int32),
                                    pay if with_pay else None))
    np.testing.assert_array_equal(got_k.numpy().view(np.uint32) ^ SIGN32,
                                  want)
    if with_pay:
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(out[1]))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_lexsort(name):
    """Ragged lengths, duplicates, all-equal keys and the types'
    extremes: the lanes in (key, payload) order, the input untouched."""
    keys, payload = CASES[name]()
    k, p = _port(keys, payload)
    got_k, got_p = sort.sort(k, p)
    want_k, want_p = expected(keys, payload)
    assert got_k.dtype == k.dtype and got_k.shape == k.shape
    np.testing.assert_array_equal(got_k.numpy(), want_k)
    if payload is None:
        assert got_p is None
    else:
        np.testing.assert_array_equal(got_p.numpy(), want_p)
        np.testing.assert_array_equal(p.numpy(), payload)
    np.testing.assert_array_equal(k.numpy(), keys)


@pytest.mark.parametrize("name", list(RADIX_PASSES))
def test_plan_counts_passes(name):
    """The plan skips the constant digits, and the payload's digits when
    the payload is nondecreasing: the pass counts of the radix cases,
    known by construction."""
    keys, payload = CASES[name]()
    assert len(sort.plan_plain(*_port(keys, payload))) == RADIX_PASSES[name]


def _radix_model(keys, payload):
    """The kernel's passes in numpy: one stable sort of the lanes by each
    digit of the plan, in the plan's order, the top byte's sign bit
    flipped."""
    order = np.arange(len(keys))
    for plane, b in sort.plan_plain(*_port(keys, payload)):
        x = (payload if plane == "payload" else keys)[order].astype(np.int64)
        d = (x >> (8 * b)) & 0xFF
        if b == (payload if plane == "payload" else keys).itemsize - 1:
            d ^= 0x80
        order = order[np.argsort(d, kind="stable")]
    return keys[order], None if payload is None else payload[order]


@pytest.mark.parametrize("name", list(CASES))
def test_radix_plan_matches_lexsort(name):
    """The plan's digit passes, run as stable passes over the lanes, give
    the contract's (key, payload) order on every case."""
    keys, payload = CASES[name]()
    got_k, got_p = _radix_model(keys, payload)
    want_k, want_p = expected(keys, payload)
    np.testing.assert_array_equal(got_k, want_k)
    if payload is not None:
        np.testing.assert_array_equal(got_p, want_p)


def test_instances_name_the_kernel():
    a64 = torch.zeros(4, dtype=torch.int64)
    a32 = torch.zeros(4, dtype=torch.int32)
    assert [sort.instance(k, p) for k, p in ((a64, None), (a64, a32),
                                             (a32, None), (a32, a32))] == \
        list(sort.INSTANCES)


def test_sort_rejects_bad_inputs():
    a = torch.zeros(8, dtype=torch.int64)
    p = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        sort.sort(a.to(torch.int16))
    with pytest.raises(TypeError):
        sort.sort(a, a)                          # int64 payload
    with pytest.raises(ValueError):
        sort.sort(a[::2])                        # not contiguous
    with pytest.raises(ValueError):
        sort.sort(a.reshape(2, 4))               # not 1-D
    with pytest.raises(ValueError):
        sort.sort(a, p[:4])                      # shape
    with pytest.raises(ValueError):
        sort.sort(a.to("meta"))                  # no kernel for the device
    with pytest.raises(ValueError):
        sort.sort(a, p.to("meta"))               # devices differ


def test_kernel_matches_plain_on_card(cuda_device):
    """On a CUDA card: the hand-written sort equals the plain version bit
    for bit on every case, leaves its input as it was, runs the passes
    of the plain plan, and each call of n >= 1 lanes counts one launch
    of its instantiation."""
    for name, build in CASES.items():
        keys, payload = build()
        k, p = _port(keys, payload, cuda_device)
        inst = sort.instance(k, p)
        before = sort.sort.mode_launches[inst]
        got = sort.sort(k, p)
        assert sort.sort.mode_launches[inst] == before + (len(keys) > 0)
        want = sort.sort_plain(k, p)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]), name
        if p is not None:
            assert torch.equal(got[1], want[1]), name
            np.testing.assert_array_equal(p.cpu().numpy(), payload)
        np.testing.assert_array_equal(k.cpu().numpy(), keys)
        if len(keys):
            assert int(sort.sort.passes) == len(sort.plan_plain(k, p)), name
