"""The merge-path kernel's two modes: the merge-reduce of the count path
(fold a sorted k-mer batch into the sorted count table) and the JOIN of
the lookup workloads (each sorted query's table count).

`merge_reduce` is the port of the TPU kernel
`yak_tpu/ops/pallas_merge.py::_make_kernel` in count mode, weighted
mode (`weights`, the Bloom-gated create pass) and wide mode (`wide`,
k >= 32).  For CUDA tensors it launches the hand-written Hopper kernel
`yak_tpu_torch/csrc/merge_reduce.cu` (see the note at its top for the
design); for CPU tensors it runs `merge_reduce_plain`, the plain torch
version of the same contract.  There is no fallback between the two: a
CUDA tensor launches the kernel or raises.  A launch is one memset, one
partition and one persistent main kernel on the current stream, with
no host read-back; the wrapper allocates the outputs and one int64
scratch tensor (tile counter, new_size and n_new, two look-back status
words a tile, the partition), sized from the host's bound on the tiles,
cap + B merged lanes.

Contract (sorttable.merge_batch_impl in ADD mode, with the zero-weight
lanes invalid, yak_tpu/ops/sorttable.py:90-171):

  tkeys   int64 [cap]  table keys, ascending and unique in [0, size)
  tcnt    int32 [cap]  table counts
  size    int32 []     live table length
  bkeys   int64 [B]    batch keys, ascending; invalid lanes = INT64_MAX
  create               False: keys absent from the table are dropped
  weights int32 [B]    None (a weight of 1 a lane), or each lane's
                       weight >= 0; a key absent from the table is then
                       created only when its weight sum is above 0
  wide                 the keys are wide-encoded k >= 32 hashes
                       (ops/keys.encode_wide), which may be negative

returns (okeys int64 [cap], ocnt int32 [cap], new_size int32 [],
n_new int32 []): every surviving key once, ascending, with count
min(table count + the sum of its batch weights, 1023).  new_size is
counted before truncation to cap, so new_size > cap is the overflow
flag; lanes beyond min(new_size, cap) are unspecified.

`merge_join` is the port of the same TPU kernel's lookup mode
(`lookup=True`, with `countstep.plookup_prep` and `plookup_post`); its
kernel is the `yak_merge_join` entry point of the same source.  Contract:

  tkeys, tcnt, size   the table, as above
  qkeys int64 [B]     query keys, ascending; invalid lanes = INT64_MAX
  qidx  int32 [B]     the original lane of each sorted query (a
                      permutation of [0, B))

returns vals int32 [B] in ORIGINAL lane order: vals[qidx[j]] is the
table count where tkeys[i] == qkeys[j] for some i < size, else -1;
invalid lanes give -1.
"""

import ctypes
import functools

import torch

from yak_tpu_torch.ops import sorttable as st
from yak_tpu_torch.ops.keys import INT64_MAX


def _check(tkeys, tcnt, size, bkeys, fn="merge_reduce"):
    for name, t, dt in (("tkeys", tkeys, torch.int64),
                        ("tcnt", tcnt, torch.int32),
                        ("size", size, torch.int32),
                        ("keys", bkeys, torch.int64)):
        if t.dtype != dt:
            raise TypeError(f"{fn}: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
        if t.device != tkeys.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, tkeys on "
                             f"{tkeys.device}")
    if tkeys.dim() != 1 or bkeys.dim() != 1 or tcnt.shape != tkeys.shape:
        raise ValueError(f"{fn}: tkeys/tcnt must be 1-D of one length and "
                         f"the batch keys 1-D")
    if size.numel() != 1:
        raise ValueError(f"{fn}: size must hold one value")
    if tkeys.numel() == 0:
        raise ValueError(f"{fn}: the table needs capacity >= 1")


def _raise_launch(lib, err, name):
    if err != 0:
        msg = lib.yak_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")


def merge_reduce(tkeys, tcnt, size, bkeys, create=True, weights=None,
                 wide=False):
    """Fold the sorted batch `bkeys` into the table (contract above)."""
    _check(tkeys, tcnt, size, bkeys)
    if weights is not None:
        if weights.dtype != torch.int32 or not weights.is_contiguous():
            raise TypeError("merge_reduce: weights must be contiguous int32")
        if weights.shape != bkeys.shape or weights.device != bkeys.device:
            raise ValueError("merge_reduce: weights and keys differ in "
                             "shape or device")
    if tkeys.device.type == "cpu":
        return merge_reduce_plain(tkeys, tcnt, size, bkeys, create, weights)
    if tkeys.device.type != "cuda":
        raise ValueError(f"merge_reduce: no kernel for device "
                         f"{tkeys.device}")
    return _launch(tkeys, tcnt, size, bkeys, create, weights, wide)


# kernel launches, counted in _launch: all of them, and by mode (a
# weighted wide launch counts in both "weighted" and "wide")
merge_reduce.launches = 0
merge_reduce.mode_launches = {"count": 0, "weighted": 0, "wide": 0}


@functools.cache
def _library():
    from yak_tpu_torch.ops import cuda_build

    lib, _secs = cuda_build.load("merge_reduce")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.yak_merge_reduce.argtypes = [
        p, p, p, i64, p, p, i64,          # inputs
        i32, i64, p,                      # create, ntiles, scratch
        p, p,                             # outputs
        p]                                # stream
    lib.yak_merge_reduce.restype = i32
    lib.yak_merge_join.argtypes = [
        p, p, p, i64, p, p, i64, i64,     # inputs, ntiles
        p, p,                             # scratch, output
        p]                                # stream
    lib.yak_merge_join.restype = i32
    lib.yak_merge_scratch_words.argtypes = [i64, i32]
    lib.yak_merge_scratch_words.restype = i64
    lib.yak_merge_reduce_tile.argtypes = []
    lib.yak_merge_reduce_tile.restype = i32
    lib.yak_cuda_error_string.argtypes = [i32]
    lib.yak_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _scratch(lib, dev, cap, nbatch, join):
    """(ntiles, scratch): the host's bound on the tiles of the merged
    stream (cap + nbatch lanes) and the kernel's int64 scratch for them
    (tile counter, new_size and n_new, the look-back status words, the
    partition); the kernel zeroes what must start at 0."""
    ntiles = max(1, -(-(cap + nbatch) // lib.yak_merge_reduce_tile()))
    words = lib.yak_merge_scratch_words(ntiles, int(join))
    return ntiles, torch.empty(words, dtype=torch.int64, device=dev)


def _launch(tkeys, tcnt, size, bkeys, create, weights, wide):
    lib = _library()
    dev = tkeys.device
    cap, nbatch = tkeys.numel(), bkeys.numel()
    ntiles, scratch = _scratch(lib, dev, cap, nbatch, join=False)
    okeys = torch.empty(cap, dtype=torch.int64, device=dev)
    ocnt = torch.empty(cap, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.yak_merge_reduce(
            tkeys.data_ptr(), tcnt.data_ptr(), size.data_ptr(), cap,
            bkeys.data_ptr(),
            None if weights is None else weights.data_ptr(), nbatch,
            int(bool(create)), ntiles, scratch.data_ptr(), okeys.data_ptr(),
            ocnt.data_ptr(), stream)
    _raise_launch(lib, err, "merge_reduce")
    merge_reduce.launches += 1
    modes = merge_reduce.mode_launches
    if weights is not None:
        modes["weighted"] += 1
    if wide:
        modes["wide"] += 1
    if weights is None and not wide:
        modes["count"] += 1
    # new_size and n_new are int32 halves 1 and 2 of the scratch's head
    head = scratch[:2].view(torch.int32)
    return okeys, ocnt, head[1], head[2]


def merge_reduce_plain(tkeys, tcnt, size, bkeys, create=True,
                       weights=None):
    """The plain torch version of the kernel's contract, in every mode:
    the sort-merge engine (sorttable.merge_batch_core) with the INT64_MAX
    and zero-weight lanes invalid; it orders wide-encoded keys as int64,
    like any other.  Data-independent shapes throughout, so it runs
    without a host sync on any device."""
    valid = bkeys != INT64_MAX
    if weights is None:
        weights = torch.ones_like(bkeys, dtype=torch.int32)
    else:
        valid = valid & (weights > 0)
    okeys, ocnt, new_size, n_new = st.merge_batch_core(
        tkeys, tcnt, size, bkeys, weights, valid, create)
    return okeys, ocnt, new_size, n_new.to(torch.int32)


def _check_join(tkeys, tcnt, size, qkeys, qidx):
    _check(tkeys, tcnt, size, qkeys, "merge_join")
    if qidx.dtype != torch.int32 or not qidx.is_contiguous():
        raise TypeError("merge_join: qidx must be contiguous int32")
    if qidx.device != tkeys.device:
        raise ValueError(f"merge_join: qidx is on {qidx.device}, tkeys on "
                         f"{tkeys.device}")
    if qidx.shape != qkeys.shape:
        raise ValueError("merge_join: qidx and qkeys differ in shape")


def merge_join(tkeys, tcnt, size, qkeys, qidx):
    """Each sorted query's table count, or -1, in original lane order
    (contract above)."""
    _check_join(tkeys, tcnt, size, qkeys, qidx)
    if tkeys.device.type == "cpu":
        return merge_join_plain(tkeys, tcnt, size, qkeys, qidx)
    if tkeys.device.type != "cuda":
        raise ValueError(f"merge_join: no kernel for device {tkeys.device}")
    return _launch_join(tkeys, tcnt, size, qkeys, qidx)


merge_join.launches = 0    # kernel launches, counted in _launch_join


def _launch_join(tkeys, tcnt, size, qkeys, qidx):
    lib = _library()
    dev = tkeys.device
    cap, nq = tkeys.numel(), qkeys.numel()
    ntiles, scratch = _scratch(lib, dev, cap, nq, join=True)
    vals = torch.empty(nq, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.yak_merge_join(
            tkeys.data_ptr(), tcnt.data_ptr(), size.data_ptr(), cap,
            qkeys.data_ptr(), qidx.data_ptr(), nq, ntiles,
            scratch.data_ptr(), vals.data_ptr(), stream)
    _raise_launch(lib, err, "merge_join")
    merge_join.launches += 1
    return vals


def merge_join_plain(tkeys, tcnt, size, qkeys, qidx):
    """The plain torch version of the JOIN: the table masked to INT64_MAX
    beyond `size`, one searchsorted, a gather and an equality test, then
    the store at qidx.  No host sync."""
    cap = tkeys.shape[0]
    lane = torch.arange(cap, dtype=torch.int64, device=tkeys.device)
    masked = torch.where(lane < size.to(torch.int64), tkeys, INT64_MAX)
    pos = torch.searchsorted(masked, qkeys).clamp_(max=cap - 1)
    hit = (masked[pos] == qkeys) & (qkeys != INT64_MAX)
    found = torch.where(hit, tcnt[pos], -1)
    vals = torch.empty_like(found)
    vals[qidx.to(torch.int64)] = found
    return vals
