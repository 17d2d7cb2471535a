"""Ascending sort of int64 or int32 keys with an optional int32 payload
riding along: the batch sort of the psort engine.

`sort` is the port of the TPU bitonic sort of
`yak_tpu/ops/pallas_sort.py` (`sort_planes`, `sort_planes32`, through
its five Pallas programs `_loop_kernel`, `_exchange_kernel_dyn`,
`_tail_kernel_dyn`, `_windowed_kernel` and `_exchange_kernel`).  For
CUDA tensors it launches the hand-written Hopper kernel
`yak_tpu_torch/csrc/sort.cu`, a stable LSD radix sort (see the note at
its top for the design); for CPU tensors it runs `sort_plain`, the plain
torch version of the same contract.  There is no fallback between the
two: a CUDA tensor launches the kernel or raises.

Contract:

  keys     int64 or int32 [n], any n >= 0, compared as signed (the
           port's key convention: k <= 31 hashes below 2^62, invalid
           lanes INT64_MAX, k >= 32 hashes wide-encoded)
  payload  None, or int32 [n]

returns (keys, payload), the lanes in ascending lexicographic order of
(key, payload); payload is None when none was given.  The TPU network
leaves the order of equal keys unspecified; ordering them by payload is
one valid refinement, under which the kernel equals the plain version
bit for bit.

The kernel runs one pass for each 8-bit digit that varies over the
lanes, key digits and, when the payload is not nondecreasing in input
order, payload digits; `plan_plain` lists them.  It decides this on the
card and reads nothing back to the host; the number of passes it ran is
left in the device int `sort.passes` of the last call.

What the TPU sort has and this one does not: the hi/lo u32 key planes,
`neg_keys` (the port's merge takes ascending keys), the power-of-two
length rule (any n is sorted as it is), more than one payload plane (no
caller passes more than one), and the compile modes.
"""

import ctypes
import functools

import torch

# the kernel's instantiations: key type, then the payload's if any
INSTANCES = ("i64", "i64_i32", "i32", "i32_i32")


def instance(keys, payload):
    """The kernel instantiation that sorts (keys, payload)."""
    name = "i64" if keys.dtype == torch.int64 else "i32"
    return name + ("" if payload is None else "_i32")


def _check(keys, payload):
    if keys.dtype not in (torch.int64, torch.int32):
        raise TypeError(f"sort: keys must be torch.int64 or torch.int32, "
                        f"got {keys.dtype}")
    if keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("sort: keys must be 1-D and contiguous")
    if payload is None:
        return
    if payload.dtype != torch.int32:
        raise TypeError(f"sort: payload must be torch.int32, got "
                        f"{payload.dtype}")
    if not payload.is_contiguous() or payload.shape != keys.shape:
        raise ValueError("sort: payload must be contiguous and of the "
                         "keys' shape")
    if payload.device != keys.device:
        raise ValueError(f"sort: payload is on {payload.device}, keys on "
                         f"{keys.device}")


def sort(keys, payload=None):
    """Sort (keys, payload) ascending (contract above)."""
    _check(keys, payload)
    if keys.device.type == "cpu":
        return sort_plain(keys, payload)
    if keys.device.type != "cuda":
        raise ValueError(f"sort: no kernel for device {keys.device}")
    return _launch(keys, payload)


# calls that launched the kernel, counted in _launch: all of them, and by
# instantiation; the device int of the last call's pass count
sort.launches = 0
sort.mode_launches = dict.fromkeys(INSTANCES, 0)
sort.passes = None


@functools.cache
def _library():
    from yak_tpu_torch.ops import cuda_build

    lib, _secs = cuda_build.load("sort")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.yak_sort.argtypes = [i32, p, p, i64,         # key bytes, inputs, n
                             p, p, p, p,             # alternate, outputs
                             p, p, p]                # scratch, passes, stream
    lib.yak_sort.restype = i32
    lib.yak_sort_scratch_bytes.argtypes = [i64]
    lib.yak_sort_scratch_bytes.restype = i64
    lib.yak_sort_error_string.argtypes = [i32]
    lib.yak_sort_error_string.restype = ctypes.c_char_p
    return lib


def _launch(keys, payload):
    n = keys.numel()
    if n == 0:
        return keys.clone(), None if payload is None else payload.clone()
    lib = _library()
    dev = keys.device
    okeys, akeys = (torch.empty(n, dtype=keys.dtype, device=dev)
                    for _ in range(2))
    opay, apay = ((None, None) if payload is None
                  else (torch.empty(n, dtype=torch.int32, device=dev)
                        for _ in range(2)))
    scratch = torch.empty(lib.yak_sort_scratch_bytes(n), dtype=torch.uint8,
                          device=dev)
    passes = torch.empty(1, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.yak_sort(keys.element_size(), keys.data_ptr(),
                           ptr(payload), n, akeys.data_ptr(), ptr(apay),
                           okeys.data_ptr(), ptr(opay), scratch.data_ptr(),
                           passes.data_ptr(), stream)
    if err != 0:
        msg = lib.yak_sort_error_string(err).decode()
        raise RuntimeError(f"sort kernel launch failed: {msg}")
    sort.launches += 1
    sort.mode_launches[instance(keys, payload)] += 1
    sort.passes = passes
    return okeys, opay


def sort_plain(keys, payload=None):
    """The plain torch version: one sort of the keys, or, with a payload,
    two stable sorts (by payload, then by key)."""
    if payload is None:
        return torch.sort(keys).values, None
    pay, order = torch.sort(payload, stable=True)
    skeys, order2 = torch.sort(keys[order], stable=True)
    return skeys, pay[order2]


def _varying_bytes(x, plane):
    """(plane, byte) of each 8-bit digit of x that is not the same in
    every lane, low byte first."""
    out = []
    for b in range(x.element_size()):
        d = (x >> (8 * b)) & 0xFF
        if bool((d != d[:1]).any()):
            out.append((plane, b))
    return out


def plan_plain(keys, payload=None):
    """The plain version of the kernel's plan: its active passes in the
    order it runs them, each (plane, byte) with plane "payload" or
    "key".  A digit that is the same in every lane is skipped; the
    payload's digits come first, and only when the payload decreases
    somewhere in input order (else a stable sort by key alone gives the
    (key, payload) order).  Reads back to the host: for checks only."""
    passes = []
    if payload is not None and bool((payload[1:] < payload[:-1]).any()):
        passes += _varying_bytes(payload, "payload")
    return passes + _varying_bytes(keys, "key")
