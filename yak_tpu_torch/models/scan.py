"""The per-segment sums loop of sexchr: one row of four sums a
sequence.

Port of the one-device part of `yak_tpu/models/scan.py`
(`scan_seg_sums`, `_fold_seg_sums`).  Per record-meta chunk, on the
table's device: the lookups (`countstep.lookup_chunk`: extract, query
sort, the JOIN kernel) and `countstep.sexchr_reduce`, which reduces the
value stream to four sums a segment, one segment a record piece of the
chunk; only the sums come back, through the lookup workloads' 2-deep
pipeline (`utils.lookup_pipeline`).  The host adds up the pieces of a
sequence that spans chunks.  The JAX package's general post and its
per-position scan (`scan_file`) have no second user here, and the mesh
versions (`scan_seg_sums_mesh`, `scan_file_mesh`, ROADMAP.md Queue 1)
are not ported.
"""

import numpy as np
import torch

from yak_tpu_torch.io.pack import pack_chunk_planes
from yak_tpu_torch.ops import countstep
from yak_tpu_torch.utils import lookup_pipeline, settle, to_host_async


def scan_seg_sums(fn, table, chunk):
    """Yield (name, seq_len, (n_k, n_sexchr, n_sex1, n_sex2)) per
    sequence of `fn`, in input order, from chunks of `chunk` bases (a
    multiple of 1024, main_sexchr's).  The engine (YAK_TPU_PSORT) is
    read once a run."""
    k = table.k
    table.flush()
    dev = table.device
    M = chunk - k + 1
    psort = countstep.psort_enabled()

    def dispatch(packed):
        nseq = len(packed.rec_gid)
        ns = max(1 << 12, 1 << int(max(nseq - 1, 1)).bit_length())
        bounds = np.full(ns + 1, M, np.int32)
        bounds[:nseq] = np.minimum(packed.rec_start, M)
        carg = pack_chunk_planes(packed, dev)
        vals, valid = countstep.lookup_chunk(carg, k, table.keys, table.cnt,
                                             table.size, psort=psort)
        sums = countstep.sexchr_reduce(vals, valid,
                                       torch.from_numpy(bounds).to(dev), M)
        return ns, to_host_async((sums,))

    def stream():
        for packed, (ns, host) in lookup_pipeline(fn, chunk, k, dispatch):
            nseq = len(packed.rec_gid)
            r = settle(host)[0].numpy().reshape(4, ns)[:, :nseq]
            yield packed, r

    yield from _fold_seg_sums(stream())


def _fold_seg_sums(stream):
    """Fold (packed, sums [4, nseq]) pairs into (name, seq_len, sums)
    rows, adding up the pieces of a sequence that spans chunks."""
    carry = None
    for packed, outs in stream:
        nseq = len(packed.rec_gid)
        continues = (int(packed.rec_off0[-1] + packed.rec_take[-1])
                     < int(packed.rec_len[-1]))
        for j in range(nseq):
            gi = int(packed.rec_gid[j])
            sums = [int(o[j]) for o in outs]
            if j == 0 and carry is not None:
                if carry[0] != gi:
                    raise RuntimeError(f"scan: the piece of sequence {gi} "
                                       f"follows an open piece of "
                                       f"{carry[0]}")
                sums = [a + b for a, b in zip(carry[1], sums)]
                carry = None
            if j == nseq - 1 and continues:
                carry = [gi, sums, packed.seq_names[gi],
                         int(packed.rec_len[j])]
            else:
                yield (packed.seq_names[gi], int(packed.rec_len[j]),
                       tuple(sums))
    if carry is not None:
        yield (carry[2], carry[3], tuple(carry[1]))
