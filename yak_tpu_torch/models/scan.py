"""The per-segment sums loop of sexchr: one row of four sums a
sequence.

Port of `yak_tpu/models/scan.py`'s `scan_seg_sums` and
`_fold_seg_sums`.  Per record-meta chunk, on the table's device: the
lookups (`countstep.lookup_chunk`: extract, query sort, the JOIN
kernel) and `countstep.sexchr_reduce`, which reduces the value stream
to four sums a segment, one segment a record piece of the chunk; only
the sums come back, through the lookup workloads' 2-deep pipeline
(`utils.lookup_pipeline`).  The host adds up the pieces of a sequence
that spans chunks (`_fold_seg_sums`).  `scan_seg_sums_mesh` (yak_tpu/models/scan.py:
187-225) does the same against a MeshTable: the routed lookups of
`parallel.mesh.mesh_routed_groups`, each chunk's sums on its own
device.  The JAX package's general post and its per-position scans
(`scan_file`, `scan_file_mesh`) have no user in the port and are not
ported.
"""

import numpy as np
import torch

from yak_tpu_torch.io.pack import pack_chunk_planes
from yak_tpu_torch.ops import countstep
from yak_tpu_torch.parallel.mesh import mesh_lookup_posts
from yak_tpu_torch.utils import lookup_pipeline, settle, to_host_async


def scan_seg_sums(fn, table, chunk):
    """Yield (name, seq_len, (n_k, n_sexchr, n_sex1, n_sex2)) per
    sequence of `fn`, in input order, from chunks of `chunk` bases (a
    multiple of 1024, main_sexchr's).  The engine (YAK_TPU_PSORT) is
    read once a run."""
    k = table.k
    table.flush()
    post = _sums_post(chunk - k + 1)
    psort = countstep.psort_enabled()

    def dispatch(packed):
        carg = pack_chunk_planes(packed, table.device)
        vals, valid = countstep.lookup_chunk(carg, k, table.keys, table.cnt,
                                             table.size, psort=psort)
        return post(packed, vals, valid)

    yield from _fold_seg_sums(_settled(lookup_pipeline(fn, chunk, k,
                                                       dispatch)))


def scan_seg_sums_mesh(fn, mtable, chunk):
    """scan_seg_sums against a MeshTable: a group's routed lookups, then
    each chunk's sums (`countstep.sexchr_reduce`) on the chunk's
    device."""
    mtable.flush()
    post = _sums_post(chunk - mtable.k + 1)
    yield from _fold_seg_sums(_settled(mesh_lookup_posts(
        fn, mtable, chunk, post, psort=countstep.psort_enabled())))


def _sums_post(M):
    """The post of a chunk's lookup: its four segment sums, one segment a
    record piece, copied to the host behind an event."""
    def post(packed, vals, valid):
        nseq = len(packed.rec_gid)
        ns = max(1 << 12, 1 << int(max(nseq - 1, 1)).bit_length())
        bounds = np.full(ns + 1, M, np.int32)
        bounds[:nseq] = np.minimum(packed.rec_start, M)
        sums = countstep.sexchr_reduce(
            vals, valid, torch.from_numpy(bounds).to(vals.device), M)
        return ns, to_host_async((sums,))
    return post


def _settled(stream):
    """(packed, sums [4, nseq]) from a stream of (packed, _sums_post's
    result)."""
    for packed, (ns, host) in stream:
        nseq = len(packed.rec_gid)
        yield packed, settle(host)[0].numpy().reshape(4, ns)[:, :nseq]


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
