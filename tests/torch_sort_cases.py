"""Seeded cases of the psort engine's sort (yak_tpu_torch/ops/sort.py),
shared by the port's CPU tests (tests/test_torch_sort.py) and its
on-card check (chip_smoke.py).

numpy only: chip_smoke.py imports this module on a machine without JAX.
Each case is (keys int64 or int32 [n], payload int32 [n] or None), one
for each of the kernel's four instantiations (int64 or int32 keys, with
or without a payload), at the lengths that matter to the CUDA kernel
(its shared-memory tile is TILE lanes; the lane count is padded to a
power of two): 0, 1, 1023, 1024, TILE - 1, TILE + 1 and 2^20 + 3, with
keys drawn over the whole type (INT64_MIN, INT64_MAX, the invalid
lanes' value, and INT32_MAX among them) or from a few values (duplicate
keys whose order the payload decides), and all-equal keys.
"""

import numpy as np

TILE = 1 << 13      # the CUDA kernel's shared-memory tile (csrc/sort.cu)
LENGTHS = (0, 1, 1023, 1024, TILE - 1, TILE + 1, (1 << 20) + 3)
INSTANCES = {"i64": (np.int64, False), "i64_i32": (np.int64, True),
             "i32": (np.int32, False), "i32_i32": (np.int32, True)}
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1


def _keys(rng, dtype, n, kind):
    info = np.iinfo(dtype)
    if kind == "equal":
        return np.full(n, 12345, dtype)
    if kind == "dups":
        vals = np.array([info.min, -7, 0, 3, I32_MAX, info.max], dtype)
        return vals[rng.integers(0, len(vals), n)]
    keys = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    special = np.array([info.min, info.max, I32_MAX, -1, 0], dtype)
    m = rng.random(n) < 0.05
    keys[m] = special[rng.integers(0, len(special), int(m.sum()))]
    return keys


def _payload(rng, n, kind):
    if kind == "dups":
        # few payload values too: lanes equal in key and payload
        return np.array([I32_MIN, -1, 0, 5, I32_MAX],
                        np.int32)[rng.integers(0, 5, n)]
    pay = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int32, endpoint=True)
    pay[rng.random(n) < 0.02] = I32_MAX
    return pay


def _case(inst, n, kind, seed):
    def build():
        dtype, with_pay = INSTANCES[inst]
        rng = np.random.default_rng(seed)
        keys = _keys(rng, dtype, n, kind)
        return keys, (_payload(rng, n, kind) if with_pay else None)
    return build


def _cases():
    cases, seed = {}, 0
    for inst in INSTANCES:
        for n in LENGTHS:
            for kind in ("random", "dups"):
                seed += 1
                cases[f"{inst}_{kind}_{n}"] = _case(inst, n, kind, seed)
        seed += 1
        cases[f"{inst}_equal_{TILE + 1}"] = _case(inst, TILE + 1, "equal",
                                                  seed)
    return cases


# name -> case maker
CASES = _cases()


def expected(keys, payload):
    """The contract in plain numpy: the lanes in ascending order of
    (key, payload)."""
    if payload is None:
        return np.sort(keys, kind="stable"), None
    order = np.lexsort((payload, keys))
    return keys[order], payload[order]
