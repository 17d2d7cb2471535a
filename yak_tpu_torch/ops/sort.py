"""Ascending sort of int64 or int32 keys with an optional int32 payload
riding along: the batch sort of the psort engine.

`sort` is the port of the TPU bitonic sort of
`yak_tpu/ops/pallas_sort.py` (`sort_planes`, `sort_planes32`, through
its five Pallas programs `_loop_kernel`, `_exchange_kernel_dyn`,
`_tail_kernel_dyn`, `_windowed_kernel` and `_exchange_kernel`).  For
CUDA tensors it launches the hand-written Hopper kernel
`yak_tpu_torch/csrc/sort.cu` (see the note at its top for the design);
for CPU tensors it runs `sort_plain`, the plain torch version of the
same contract.  There is no fallback between the two: a CUDA tensor
launches the kernel or raises.

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

What the TPU sort has and this one does not: the hi/lo u32 key planes,
`neg_keys` (the port's merge takes ascending keys), the power-of-two
length rule (the kernel pads internally), more than one payload plane
(no caller passes more than one), and the compile modes.
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
# instantiation
sort.launches = 0
sort.mode_launches = dict.fromkeys(INSTANCES, 0)


@functools.cache
def _library():
    from yak_tpu_torch.ops import cuda_build

    lib, _secs = cuda_build.load("sort")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.yak_sort.argtypes = [i32, p, p, i64, i64,    # key bytes, inputs, n, n2
                             p, p,                   # outputs
                             p]                      # stream
    lib.yak_sort.restype = i32
    lib.yak_sort_error_string.argtypes = [i32]
    lib.yak_sort_error_string.restype = ctypes.c_char_p
    return lib


def _launch(keys, payload):
    n = keys.numel()
    if n == 0:
        return keys.clone(), None if payload is None else payload.clone()
    lib = _library()
    dev = keys.device
    n2 = 1 << (n - 1).bit_length()
    okeys = torch.empty(n2, dtype=keys.dtype, device=dev)
    opay = (None if payload is None
            else torch.empty(n2, dtype=torch.int32, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.yak_sort(
            keys.element_size(), keys.data_ptr(),
            None if payload is None else payload.data_ptr(), n, n2,
            okeys.data_ptr(), None if opay is None else opay.data_ptr(),
            stream)
    if err != 0:
        msg = lib.yak_sort_error_string(err).decode()
        raise RuntimeError(f"sort kernel launch failed: {msg}")
    sort.launches += 1
    sort.mode_launches[instance(keys, payload)] += 1
    return okeys[:n], None if opay is None else opay[:n]


def sort_plain(keys, payload=None):
    """The plain torch version: one sort of the keys, or, with a payload,
    two stable sorts (by payload, then by key)."""
    if payload is None:
        return torch.sort(keys).values, None
    pay, order = torch.sort(payload, stable=True)
    skeys, order2 = torch.sort(keys[order], stable=True)
    return skeys, pay[order2]
