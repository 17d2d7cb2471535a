"""int64 key helpers.

torch on the CPU has no `>>`, `<<`, `+` or `<` for uint32/uint64, so the
port carries every key as int64:

- a k <= 31 canonical hash is below 2^62, so it is non-negative as int64
  and signed order is unsigned order;
- the invalid/INF sentinel (beyond-size table lanes, invalid batch lanes)
  is INT64_MAX, which sorts after every real key;
- u32 bit-plane words ride in int64 lanes (values in [0, 2^32)), where
  `>>` is a logical shift.

Host arrays cross as numpy uint64 <-> torch int64 by reinterpreting the
bytes, never by value conversion.
"""

import numpy as np
import torch

INT64_MAX = (1 << 63) - 1
U32_MASK = 0xFFFFFFFF


def u64_to_torch(a, device="cpu"):
    """numpy uint64 (values < 2^63) -> torch int64 on `device`, in memory
    of its own (never aliasing the caller's array)."""
    a = np.array(a, dtype=np.uint64, copy=True)
    return torch.from_numpy(a.view(np.int64)).to(device)


def torch_to_u64(t):
    """torch int64 (non-negative) -> numpy uint64, bit for bit."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def u32_to_torch(a, device="cpu"):
    """numpy uint32 words -> torch int64 words in [0, 2^32) on `device`.

    The h2d copy moves the 4-byte words (as int32); the widening to
    int64 and the unsigned mask run on the device."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    t = torch.from_numpy(a.view(np.int32)).to(device)
    return t.to(torch.int64) & U32_MASK
