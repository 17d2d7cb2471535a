"""The port's merge-JOIN (ops/merge.merge_join, plain torch version on the
CPU) against the JAX package's Pallas merge-path kernel in lookup mode
(countstep.lookup_pallas, interpret mode) and its XLA lookup; and the
port's per-chunk lookup step (ops/countstep.lookup_chunk) against the
JAX package's scan step.  Every value is an integer: all comparisons
are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_join_cases import CASES, expected, table_arrays
from yak_tpu.io.pack import pack_chunk_planes as jax_pack_chunk_planes
from yak_tpu.ops import sorttable as jst
from yak_tpu.ops.countstep import get_scan_step, lookup_pallas
from yak_tpu_torch.io.pack import (PackedChunk, detect_periodic_meta,
                                   pack_chunk_planes)
from yak_tpu_torch.ops import merge
from yak_tpu_torch.ops.countstep import extract, lookup_chunk
from yak_tpu_torch.ops.keys import INT64_MAX, u64_to_torch


@pytest.fixture
def cuda_device():
    """The card, decided when the test runs; skips where there is none
    (a CUDA kernel has no CPU mode; chip_smoke.py runs the same check
    on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card for the hand-written kernel")
    return torch.device("cuda")


def _port_args(tk, tc, n, batch, valid, device="cpu"):
    """The JOIN's arguments as the lookup step builds them: the queries
    sorted with INT64_MAX for invalid lanes, their lanes as payload."""
    h = u64_to_torch(batch, device)
    v = torch.from_numpy(valid).to(device)
    qkeys, order = torch.sort(torch.where(v, h, INT64_MAX))
    return (u64_to_torch(tk, device), torch.from_numpy(tc).to(device),
            torch.tensor(n, dtype=torch.int32, device=device), qkeys,
            order.to(torch.int32))


@pytest.mark.parametrize("name", list(CASES))
def test_join_matches_jax(name):
    hs, cs, batch, valid, cap, stale = CASES[name]()
    tk, tc, n = table_arrays(hs, cs, cap, stale)
    got = merge.merge_join(*_port_args(tk, tc, n, batch, valid)).numpy()
    np.testing.assert_array_equal(got, expected(hs, cs, batch, valid))
    jargs = (jnp.asarray(tk), jnp.asarray(tc), jnp.int32(n),
             jnp.asarray(batch), jnp.asarray(valid))
    np.testing.assert_array_equal(
        got, np.asarray(lookup_pallas(*jargs, interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(jst.lookup(*jargs, packable=True)))


def test_join_rejects_bad_inputs():
    keys = torch.zeros(16, dtype=torch.int64)
    cnt = torch.zeros(16, dtype=torch.int32)
    size = torch.zeros((), dtype=torch.int32)
    q = torch.zeros(8, dtype=torch.int64)
    idx = torch.arange(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        merge.merge_join(keys, cnt, size, q, idx.to(torch.int64))
    with pytest.raises(ValueError):
        merge.merge_join(keys, cnt, size, q, idx[:4])
    with pytest.raises(TypeError):
        merge.merge_join(keys, cnt.to(torch.int64), size, q, idx)


def _chunk(periodic, seed, L=1 << 14, R=100):
    """One flat code chunk with record metadata: reads of R bases
    (periodic layout) or ragged records with N runs (general)."""
    rng = np.random.default_rng(seed)
    p = PackedChunk(L, full_meta=False)
    recs, w = [], 0
    while True:
        n = R if periodic else int(rng.integers(10, 400))
        if w + n > L - 200:
            break
        seq = rng.integers(0, 4, n).astype(np.uint8)
        if not periodic and n > 50:
            seq[rng.integers(0, n - 10):][:6] = 4
        p.codes[w:w + n] = seq
        recs.append([len(recs), n, w, 0, n])
        w += n + 1
    p._recs = recs
    p._finish_recs()
    p.n_bases = sum(r[1] for r in recs)
    assert (detect_periodic_meta(p) is not None) == periodic
    return p


@pytest.mark.parametrize("periodic", [True, False])
def test_lookup_chunk_matches_jax_scan_step(periodic):
    """extract + query sort + JOIN of one chunk == the JAX package's
    per-window lookup (value, -2 where the window holds an N)."""
    p = _chunk(periodic, 30 + periodic)
    k = 21
    rng = np.random.default_rng(5)
    # a table of half of the chunk's distinct k-mers, random counts
    carg = pack_chunk_planes(p, "cpu")
    h, valid = extract(carg, k)
    live = np.unique(h.reshape(-1)[valid.reshape(-1)].numpy()
                     .view(np.uint64))
    hs = rng.choice(live, len(live) // 2, replace=False)
    cs = rng.integers(0, 1024, len(hs)).astype(np.int32)
    tk, tc, n = table_arrays(hs, cs, 1 << 14, np.zeros(0, np.uint64))
    vals, v = lookup_chunk(carg, k, u64_to_torch(tk), torch.from_numpy(tc),
                           torch.tensor(n, dtype=torch.int32))
    got = torch.where(v, vals, -2).numpy()
    jarg, planes_key = jax_pack_chunk_planes(p.codes, p)
    want = np.asarray(get_scan_step(k, planes_L=planes_key)(
        jarg, jnp.asarray(tk), jnp.asarray(tc), jnp.int32(n))).reshape(-1)
    assert (got >= 0).sum() > 1000 and (got == -1).sum() > 1000
    np.testing.assert_array_equal(got, want)


def test_join_kernel_matches_plain_on_card(cuda_device):
    """On a CUDA card: the hand-written JOIN equals the plain version on
    every case, and each call counts one launch."""
    for name, build in CASES.items():
        hs, cs, batch, valid, cap, stale = build()
        tk, tc, n = table_arrays(hs, cs, cap, stale)
        args = _port_args(tk, tc, n, batch, valid, cuda_device)
        before = merge.merge_join.launches
        got = merge.merge_join(*args)
        assert merge.merge_join.launches == before + 1
        want = merge.merge_join_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
