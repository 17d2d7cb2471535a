"""int64 key helpers.

torch on the CPU has no `>>`, `<<`, `+` or `<` for uint32/uint64, so the
port carries every key as int64:

- a k <= 31 canonical hash is below 2^62, so it is non-negative as int64
  and signed order is unsigned order;
- a k >= 32 hash (yak_hash_long) uses all 64 bits; the table and the
  batch carry it "wide-encoded", `h ^ (1 << 63)`, so that int64 order
  is its unsigned order (`encode_wide`, `decode_wide`);
- the invalid/INF sentinel (beyond-size table lanes, invalid batch lanes)
  is INT64_MAX, which sorts after every real key; a raw wide hash of
  0xFF..FF would encode to it, so it is clamped to 0xFF..FE first, as
  the TPU kernel's wide mode clamps it (countstep._xs_planes);
- u32 bit-plane words ride in int64 lanes (values in [0, 2^32)), where
  `>>` is a logical shift;
- a right shift of a full 64-bit value is arithmetic in torch, so the
  logical shift the reference's uint64 code means is `srl`.

Host arrays cross as numpy uint64 <-> torch int64 by reinterpreting the
bytes, never by value conversion.
"""

import numpy as np
import torch

INT64_MAX = (1 << 63) - 1
SIGN = -(1 << 63)          # the int64 bit pattern of 1 << 63
U32_MASK = 0xFFFFFFFF


def srl(x, s):
    """Logical right shift of int64 lanes holding u64 bit patterns by a
    Python int 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def encode_wide(h):
    """Raw 64-bit hashes (int64 bit patterns) -> the wide key encoding:
    0xFF..FF clamped to 0xFF..FE, then the sign bit flipped."""
    return torch.where(h == -1, -2, h) ^ SIGN


def decode_wide(keys):
    """The wide key encoding -> raw 64-bit hashes (int64 bit patterns)."""
    return keys ^ SIGN


def i32_bits(x):
    """The low 32 bits of int64 lanes as int32 bit patterns."""
    x = x & U32_MASK
    return (x - ((x & 0x80000000) << 1)).to(torch.int32)


def u64_to_torch(a, device="cpu"):
    """numpy uint64 -> torch int64 (the same bits) on `device`, in memory
    of its own (never aliasing the caller's array)."""
    a = np.array(a, dtype=np.uint64, copy=True)
    return torch.from_numpy(a.view(np.int64)).to(device)


def torch_to_u64(t):
    """torch int64 -> numpy uint64, bit for bit."""
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def u32_to_torch(a, device="cpu"):
    """numpy uint32 words -> torch int64 words in [0, 2^32) on `device`.

    The h2d copy moves the 4-byte words (as int32); the widening to
    int64 and the unsigned mask run on the device."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    t = torch.from_numpy(a.view(np.int32)).to(device)
    return t.to(torch.int64) & U32_MASK
