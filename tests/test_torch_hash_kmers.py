"""The port's hash, plane packing and k-mer extraction (k <= 31) against
the JAX package's, on the same seeded inputs.  Exact comparisons."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yak_tpu.io import pack as jpack
from yak_tpu.ops import kmers as jkmers
from yak_tpu.ops.hash import hash64 as jhash64
from yak_tpu_torch.io import pack
from yak_tpu_torch.ops import kmers
from yak_tpu_torch.ops.hash import hash64, kmer_mask
from yak_tpu_torch.ops.keys import torch_to_u64, u32_to_torch, u64_to_torch


@pytest.mark.parametrize("k", [3, 17, 31])
def test_hash64_matches_numpy_reference(k):
    rng = np.random.default_rng(k)
    mask = (1 << (2 * k)) - 1
    keys = rng.integers(0, 1 << 62, 20000, dtype=np.uint64) & np.uint64(mask)
    keys[:3] = [0, mask, 1]
    want = jhash64(keys, np.uint64(mask), ns=np)
    got = torch_to_u64(hash64(u64_to_torch(keys), kmer_mask(k)))
    np.testing.assert_array_equal(got, want)


def _general_chunks(rng, G, L):
    """Random codes with N runs, single Ns and an all-N chunk tail."""
    codes = rng.integers(0, 4, (G, L)).astype(np.uint8)
    codes[0, 100:140] = 4
    codes[1, rng.integers(0, L, 25)] = 4
    codes[-1, L - 77:] = 4
    return codes


def _periodic_chunk(rng, L, R, m, tail):
    """[R bases][N] * m, then `tail` (<= R) bases, then all-N pad."""
    c = np.full(L, 4, np.uint8)
    for j in range(m):
        c[j * (R + 1):j * (R + 1) + R] = rng.integers(0, 4, R)
    off = m * (R + 1)
    c[off:off + tail] = rng.integers(0, 4, tail)
    return c


def _assert_same(h, valid, jh, jvalid):
    jvalid = np.asarray(jvalid)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    got = torch_to_u64(h)[jvalid]
    want = np.asarray(jh)[jvalid]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.sort(want))


@pytest.mark.parametrize("k", [3, 17, 31])
def test_extract_from_planes_matches_jax(k):
    rng = np.random.default_rng(100 + k)
    G, L = 3, 700
    codes = _general_chunks(rng, G, L)
    planes = pack.pack_planes(codes)
    for a, b in zip(planes, jpack.pack_planes(codes)):
        np.testing.assert_array_equal(a, b)
    h, valid = kmers.extract_from_planes(
        *(u32_to_torch(p) for p in planes), k, L)
    jh, jvalid = jkmers.extract_from_planes(
        *(jnp.asarray(p) for p in planes), k, L)
    assert int(valid.sum()) > 0
    _assert_same(h, valid, jh, jvalid)


@pytest.mark.parametrize("k", [3, 17, 31])
def test_extract_periodic_matches_jax(k):
    rng = np.random.default_rng(200 + k)
    L, R = 1024, 48
    chunks = [_periodic_chunk(rng, L, R, 18, 30),
              _periodic_chunk(rng, L, R, 20, 0),
              np.full(L, 4, np.uint8)]          # an all-pad fill chunk
    pers = [pack.detect_periodic(c) for c in chunks[:2]] + [(R, 0)]
    assert pers[:2] == [jpack.detect_periodic(c) for c in chunks[:2]]
    assert all(p is not None and p[0] == R for p in pers)
    codes = np.stack(chunks)
    plo, phi = pack.pack_planes2(codes)
    wvec = np.array([p[1] for p in pers], np.int32)
    h, valid = kmers.extract_periodic(u32_to_torch(plo), u32_to_torch(phi),
                                      torch.from_numpy(wvec), k, L, R)
    jh, jvalid = jkmers.extract_periodic(jnp.asarray(plo), jnp.asarray(phi),
                                         jnp.asarray(wvec), k, L, R)
    assert int(valid.sum()) == 18 * (R - k + 1) + max(30 - k + 1, 0) \
        + 20 * (R - k + 1)
    _assert_same(h, valid, jh, jvalid)


def test_extract_rejects_wide_k():
    """k = 64 and above is no k-mer size of yak's (main.c: -k must be
    smaller than 64); k in [32, 63] is tests/test_torch_wide.py's."""
    z = torch.zeros((1, 3), dtype=torch.int64)
    for k in (0, 64):
        with pytest.raises(ValueError, match="63"):
            kmers.extract_from_planes(z, z, z, k, 80)
        with pytest.raises(ValueError, match="63"):
            kmers.extract_periodic(z, z, z[:, 0], k, 80, 79)
