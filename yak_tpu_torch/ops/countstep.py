"""The count fold: packed planes -> k-mer hashes -> sorted batch ->
merge-reduce into the table.

Port of the default count engine of `yak_tpu/ops/countstep.py`
(`get_count_step_pmerge{,_planes}`, `_pmerge_prep_core`,
`finalize_pmerge`, `pmerge_overflow`).  The batch sort is `torch.sort`,
as the JAX package's is `lax.sort` in XLA (countstep.py:215-239); the
merge is the hand-written kernel (`ops/merge.py`).  The batch travels as
plain ascending int64 keys with INT64_MAX for invalid lanes: the TPU
prep's complement trick, stream bit and u32 planes exist for the TPU
kernel only.

The step never writes into its inputs, so the caller keeps the pre-step
table and can replay the fold after growing it (`table.KmerTable`).
"""

import torch

from yak_tpu_torch.ops import merge
from yak_tpu_torch.ops.keys import INT64_MAX
from yak_tpu_torch.ops.kmers import extract_from_planes, extract_periodic


def extract(carg, k):
    """Hashes and validity of one fold's chunks.

    carg is ("periodic", (plo, phi, wvec), L, R) for the fixed-length-read
    layout (2 planes on the wire) or ("planes", (plo, phi, pnn), L) for
    the general layout (3 planes)."""
    if carg[0] == "periodic":
        _, (plo, phi, wvec), L, R = carg
        return extract_periodic(plo, phi, wvec, k, L, R)
    _, (plo, phi, pnn), L = carg
    return extract_from_planes(plo, phi, pnn, k, L)


def sort_batch(h, valid):
    """Flatten and sort a hash batch ascending; invalid lanes become
    INT64_MAX and sort to the tail."""
    keys = torch.where(valid, h, INT64_MAX).reshape(-1)
    return torch.sort(keys).values


def count_step(carg, k, tkeys, tcnt, size, create, hook=None):
    """One fold: extract + sort + merge-reduce + finalize.

    Returns (keys, cnt, size, n_new, overflow): the new table truncated
    to cap, its live size min(new_size, cap), the created-key count and
    the device overflow flag new_size > cap.  `hook`, when given, is
    called with each phase's name as the phase is queued."""
    mark = hook or (lambda _name: None)
    h, valid = extract(carg, k)
    mark("extract")
    bkeys = sort_batch(h, valid)
    mark("sort")
    okeys, ocnt, new_size, n_new = merge.merge_reduce(tkeys, tcnt, size,
                                                      bkeys, create)
    mark("merge")
    out = finalize(okeys, ocnt, new_size, n_new, tkeys.shape[0])
    mark("finalize")
    return out


def finalize(okeys, ocnt, new_size, n_new, cap):
    """Merge-reduce outputs -> table state + flags (the port of
    countstep.finalize_pmerge and pmerge_overflow)."""
    return (okeys, ocnt, torch.clamp(new_size, max=cap),
            n_new.to(torch.int64), new_size > cap)
