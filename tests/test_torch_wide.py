"""k in [32, 63] on the port: `hash_long` and the 64-bit funnel
extraction against the JAX package's, the wide-encoded table's state
bridge, and `.yak` dumps of k = 33 and k = 63 counts byte-identical to
the JAX package's.  Exact comparisons."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yak_tpu.io import pack as jpack
from yak_tpu.models import count as jcount
from yak_tpu.ops import kmers as jkmers
from yak_tpu.ops.hash import hash64_64 as jhash64_64
from yak_tpu.ops.hash import hash_long as jhash_long
from yak_tpu_torch.io import pack
from yak_tpu_torch.models import count as pcount
from yak_tpu_torch.ops import kmers
from yak_tpu_torch.ops.hash import hash64_64, hash_long
from yak_tpu_torch.ops.keys import torch_to_u64, u32_to_torch, u64_to_torch
from yak_tpu_torch.table import KmerTable

ALPH = np.frombuffer(b"ACGT", np.uint8)


@pytest.mark.parametrize("k", [32, 47, 63])
def test_hash_long_matches_jax(k):
    rng = np.random.default_rng(k)
    planes = [rng.integers(0, 1 << k, 20000, dtype=np.uint64)
              for _ in range(4)]
    planes[1][:5] = planes[3][:5]          # equal strand planes
    want = jhash_long(*planes, ns=np)
    got = hash_long(*(u64_to_torch(p) for p in planes))
    np.testing.assert_array_equal(torch_to_u64(got), want)
    full = rng.integers(0, 1 << 64, 20000, dtype=np.uint64)
    full[:3] = [0, (1 << 64) - 1, 1 << 63]
    np.testing.assert_array_equal(torch_to_u64(hash64_64(u64_to_torch(full))),
                                  jhash64_64(full, ns=np))


def _same(h, valid, jh, jvalid):
    jvalid = np.asarray(jvalid)
    np.testing.assert_array_equal(valid.numpy(), jvalid)
    np.testing.assert_array_equal(torch_to_u64(h)[jvalid],
                                  np.asarray(jh)[jvalid])


@pytest.mark.parametrize("k", [32, 33, 47, 63])
def test_wide_extract_from_planes_matches_jax(k):
    rng = np.random.default_rng(300 + k)
    G, L = 3, 700
    codes = rng.integers(0, 4, (G, L)).astype(np.uint8)
    codes[0, 100:140] = 4
    codes[1, rng.integers(0, L, 25)] = 4
    codes[-1, L - 77:] = 4
    planes = pack.pack_planes(codes)
    h, valid = kmers.extract_from_planes(
        *(u32_to_torch(p) for p in planes), k, L)
    jh, jvalid = jkmers.extract_from_planes(
        *(jnp.asarray(p) for p in planes), k, L)
    assert int(valid.sum()) > 1000
    _same(h, valid, jh, jvalid)


@pytest.mark.parametrize("k", [33, 63])
def test_wide_extract_periodic_matches_jax(k):
    rng = np.random.default_rng(400 + k)
    L, R = 2048, 96
    chunks = []
    for m, tail in ((18, 70), (21, 0)):
        c = np.full(L, 4, np.uint8)
        for j in range(m):
            c[j * (R + 1):j * (R + 1) + R] = rng.integers(0, 4, R)
        c[m * (R + 1):m * (R + 1) + tail] = rng.integers(0, 4, tail)
        chunks.append(c)
    pers = [pack.detect_periodic(c) for c in chunks]
    assert pers == [jpack.detect_periodic(c) for c in chunks]
    plo, phi = pack.pack_planes2(np.stack(chunks))
    wvec = np.array([p[1] for p in pers], np.int32)
    h, valid = kmers.extract_periodic(u32_to_torch(plo), u32_to_torch(phi),
                                      torch.from_numpy(wvec), k, L, R)
    jh, jvalid = jkmers.extract_periodic(jnp.asarray(plo), jnp.asarray(phi),
                                         jnp.asarray(wvec), k, L, R)
    assert int(valid.sum()) == 39 * (R - k + 1) + max(70 - k + 1, 0)
    _same(h, valid, jh, jvalid)


def test_wide_table_state_bridge():
    """Raw k >= 32 hashes (keys >= 2^63 among them) cross from_arrays and
    to_arrays unchanged; items come back in unsigned order; a fold of
    raw hashes counts them."""
    rng = np.random.default_rng(9)
    keys = np.unique(rng.integers(0, 1 << 64, 3000, dtype=np.uint64))
    assert (keys >= np.uint64(1 << 63)).any() and (keys < (1 << 63)).any()
    cap = 1 << 13
    tk = np.zeros(cap, np.uint64)
    tc = np.full(cap, -1, np.int32)
    tk[:len(keys)] = keys
    tc[:len(keys)] = rng.integers(1, 50, len(keys))
    t = KmerTable.from_arrays(tk, tc, len(keys), 33, 10, "cpu")
    assert t.wide
    back_k, back_c, n = t.to_arrays()
    np.testing.assert_array_equal(back_k, tk)
    np.testing.assert_array_equal(back_c, tc)
    t.insert_hashes(u64_to_torch(keys[-5:]), torch.ones(5, dtype=torch.bool),
                    create_new=False)
    h, c = t.items()
    np.testing.assert_array_equal(h, keys)
    np.testing.assert_array_equal(c[-5:], tc[len(keys) - 5:len(keys)] + 1)


def _write_reads(path, rng, n=500, read_len=127):
    g = rng.integers(0, 4, 6000)
    with open(path, "wb") as f:
        for i in range(n):
            s = rng.integers(0, len(g) - read_len)
            r = g[s:s + read_len].copy()
            r[rng.random(read_len) < 0.003] = rng.integers(0, 4)
            if rng.random() < 0.5:
                r = (3 - r)[::-1]
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, ALPH[r].tobytes(),
                                              b"I" * read_len))


@pytest.mark.parametrize("k", [33, 63])
def test_wide_count_dump_matches_jax(tmp_path, k):
    src = str(tmp_path / "reads.fq")
    _write_reads(src, np.random.default_rng(k))
    chunk = 16384
    t = pcount.count_file(src, pcount.CountOpts(k=k, chunk_size=chunk,
                                                device="cpu"))
    t.dump(str(tmp_path / "port.yak"))
    jt = jcount.count_file(src, jcount.CountOpts(k=k, chunk_size=chunk))
    jt.dump(str(tmp_path / "jax.yak"))
    assert t.tot > 1000 and t.wide
    assert ((tmp_path / "port.yak").read_bytes()
            == (tmp_path / "jax.yak").read_bytes())
