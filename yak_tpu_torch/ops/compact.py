"""Stable stream compaction: drop marked lanes, pack the kept ones to the
front in order.

`compact` is the port of the TPU kernel
`yak_tpu/ops/pallas_compact.py::_kernel` (`compact_raw`, `compact_u32`).
For CUDA tensors it launches the hand-written Hopper kernel
`yak_tpu_torch/csrc/compact.cu` (see the note at its top for the
design); for CPU tensors it runs `compact_plain`, the plain torch
version of the same contract.  There is no fallback between the two: a
CUDA tensor launches the kernel or raises.

Contract:

  khi, klo, v  int32 [n]   three planes; a lane is dropped where khi < 0
                           (bit 31 set: the JAX package's marker
                           0x80000000); n < 2^31; the planes may
                           alias one another and need not be 16-byte
                           aligned

returns (ohi, olo, ov int32 [n], n_kept int32 []): the kept lanes first,
in input order; lanes from n_kept on are unspecified.  On the card each
plane is an allocation of its own, and n_kept a view of the call's
scratch (one 8-byte word a 16384-lane tile).
"""

import ctypes
import functools

import torch


def _check(khi, klo, v):
    for name, t in (("khi", khi), ("klo", klo), ("v", v)):
        if t.dtype != torch.int32:
            raise TypeError(f"compact: {name} must be torch.int32, got "
                            f"{t.dtype}")
        if not t.is_contiguous() or t.dim() != 1:
            raise ValueError(f"compact: {name} must be 1-D and contiguous")
        if t.device != khi.device or t.shape != khi.shape:
            raise ValueError("compact: the planes differ in device or shape")
    if khi.numel() >= 1 << 31:
        raise ValueError(f"compact: {khi.numel()} lanes; n_kept is int32, "
                         f"so n must be below 2^31")


def compact(khi, klo, v):
    """Stable compaction of the lanes with khi >= 0 (contract above)."""
    _check(khi, klo, v)
    if khi.device.type == "cpu":
        return compact_plain(khi, klo, v)
    if khi.device.type != "cuda":
        raise ValueError(f"compact: no kernel for device {khi.device}")
    return _launch(khi, klo, v)


compact.launches = 0    # kernel launches, counted in _launch


@functools.cache
def _library():
    from yak_tpu_torch.ops import cuda_build

    lib, _secs = cuda_build.load("compact")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.yak_compact.argtypes = [p, p, p, i64,   # inputs, n
                                p,              # scratch
                                p, p, p,        # outputs
                                p, i32]         # stream, device
    lib.yak_compact.restype = i32
    lib.yak_compact_scratch_words.argtypes = [p, i64]
    lib.yak_compact_scratch_words.restype = i64
    lib.yak_compact_tile.argtypes = []
    lib.yak_compact_tile.restype = i32
    lib.yak_compact_error_string.argtypes = [i32]
    lib.yak_compact_error_string.restype = ctypes.c_char_p
    return lib


def _launch(khi, klo, v):
    lib = _library()
    n = khi.numel()
    # the tile counter with n_kept as its high half, then the status words
    scratch = torch.empty(lib.yak_compact_scratch_words(khi.data_ptr(), n),
                          dtype=torch.int64, device=khi.device)
    ohi, olo, ov = (torch.empty(n, dtype=torch.int32, device=khi.device)
                    for _ in range(3))
    err = lib.yak_compact(
        khi.data_ptr(), klo.data_ptr(), v.data_ptr(), n, scratch.data_ptr(),
        ohi.data_ptr(), olo.data_ptr(), ov.data_ptr(),
        torch.cuda.current_stream(khi.device).cuda_stream, khi.device.index)
    if err != 0:
        msg = lib.yak_compact_error_string(err).decode()
        raise RuntimeError(f"compact kernel launch failed: {msg}")
    compact.launches += 1
    return ohi, olo, ov, scratch.view(torch.int32)[1]


def compact_plain(khi, klo, v):
    """The plain torch version: each kept lane's output position is its
    running kept count; dropped lanes go to one spare lane past n, which
    is cut off.  No host sync."""
    n = khi.shape[0]
    keep = khi >= 0
    dst = torch.where(keep, torch.cumsum(keep, 0) - 1, n)
    outs = []
    for plane in (khi, klo, v):
        o = torch.zeros(n + 1, dtype=torch.int32, device=khi.device)
        o.scatter_(0, dst, plane)
        outs.append(o[:n])
    return outs[0], outs[1], outs[2], keep.sum().to(torch.int32)
