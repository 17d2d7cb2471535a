"""The last set lane of a mask: for each lane i, the last lane j <= i
where the mask is set, else -1 (int32).  It is the running maximum of
`torch.where(mask, lane, -1)`, which the JAX package computes with
`jax.lax.cummax`.  The default engine's Bloom gate posts call it, for
their key runs and the sparse filter update's word runs; the plain
torch paths (the sort-merge engines and their gate, the sorted join,
trio's type runs) keep `sorttable.last_set_lane`, library calls alone.

For CUDA tensors `last_set_lane` launches the hand-written Hopper kernel
`yak_tpu_torch/csrc/scan.cu` (see the note at its top for the design),
one pass that reads the mask and writes the answer; `torch.cummax`
scans a 1-D tensor in one block on the card.  For CPU tensors it runs
`last_set_lane_plain`, that cummax, which is one linear pass there.
There is no fallback between the two: a CUDA tensor launches the kernel
or raises.

Contract: mask bool or uint8 [n], 1-D and contiguous (a lane is set
where it is not 0), n < 2^31; returns int32 [n].
"""

import ctypes
import functools

import torch


def _check(mask):
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"last_set_lane: mask must be torch.bool or "
                        f"torch.uint8, got {mask.dtype}")
    if not mask.is_contiguous() or mask.dim() != 1:
        raise ValueError("last_set_lane: mask must be 1-D and contiguous")
    if mask.numel() >= 1 << 31:
        raise ValueError(f"last_set_lane: {mask.numel()} lanes; the "
                         f"answer is int32, so n must be below 2^31")


def last_set_lane(mask):
    """For each lane, the last set lane at or before it, else -1 (int32;
    contract above)."""
    _check(mask)
    if mask.device.type == "cpu":
        return last_set_lane_plain(mask)
    if mask.device.type != "cuda":
        raise ValueError(f"last_set_lane: no kernel for device {mask.device}")
    return _launch(mask)


last_set_lane.launches = 0    # kernel launches, counted in _launch


def last_set_lane_plain(mask):
    """The plain torch version: torch.cummax of the set lanes' indices."""
    lane = torch.arange(mask.numel(), dtype=torch.int32, device=mask.device)
    return torch.cummax(torch.where(mask.bool(), lane, -1), 0).values


@functools.cache
def _library():
    from yak_tpu_torch.ops import cuda_build

    lib, _secs = cuda_build.load("scan")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.yak_last_set_lane.argtypes = [p, i64,    # mask, n
                                      p, p,      # scratch, output
                                      p, i32]    # stream, device
    lib.yak_last_set_lane.restype = i32
    lib.yak_last_set_lane_scratch_words.argtypes = [i64]
    lib.yak_last_set_lane_scratch_words.restype = i64
    lib.yak_last_set_lane_tile.argtypes = []
    lib.yak_last_set_lane_tile.restype = i32
    lib.yak_last_set_lane_error_string.argtypes = [i32]
    lib.yak_last_set_lane_error_string.restype = ctypes.c_char_p
    return lib


def _launch(mask):
    n = mask.numel()
    out = torch.empty(n, dtype=torch.int32, device=mask.device)
    if n == 0:
        return out
    lib = _library()
    # the tile counter, then the status words
    scratch = torch.empty(lib.yak_last_set_lane_scratch_words(n),
                          dtype=torch.int64, device=mask.device)
    err = lib.yak_last_set_lane(
        mask.data_ptr(), n, scratch.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(mask.device).cuda_stream,
        mask.device.index)
    if err != 0:
        msg = lib.yak_last_set_lane_error_string(err).decode()
        raise RuntimeError(f"last_set_lane kernel launch failed: {msg}")
    last_set_lane.launches += 1
    return out
