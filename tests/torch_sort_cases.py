"""Seeded cases of the psort engine's sort (yak_tpu_torch/ops/sort.py),
shared by the port's CPU tests (tests/test_torch_sort.py) and its
on-card check (chip_smoke.py).

numpy only: chip_smoke.py imports this module on a machine without JAX.
Each case is (keys int64 or int32 [n], payload int32 [n] or None), one
for each of the kernel's four instantiations (int64 or int32 keys, with
or without a payload), at ragged lengths (0, 1, 1023, 1024, 2^13 - 1,
2^13 + 1 and 2^20 + 3), with keys drawn over the whole type (INT64_MIN,
INT64_MAX, the invalid lanes' value, and INT32_MAX among them) or from
a few values (duplicate keys whose order the payload decides), and
all-equal keys.

RADIX_CASES add what the radix kernel decides from the data: keys in
[0, 8000] (the high bytes constant, as qv's region keys), hashes below
2^62 with INT64_MAX lanes (a count fold's batch), keys that are
multiples of 2^16 (the low bytes constant), every digit constant (no
pass at all), an iota payload and a nondecreasing payload with repeats
(the payload passes skipped), an unsorted payload under heavy key ties
(the payload passes run), chkerr's marker shape (the run-end lane or
INT32_MAX, by run length), and lengths around its tile of RADIX_TILE
lanes, with one bucket over several tiles.  RADIX_PASSES gives each
one's number of passes by construction.
"""

import numpy as np

TILE = 1 << 13
LENGTHS = (0, 1, 1023, 1024, TILE - 1, TILE + 1, (1 << 20) + 3)
RADIX_TILE = 256 * 15     # lanes a tile of the radix kernel (csrc/sort.cu)
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


def _radix_keys(rng, dtype, n, kind):
    if kind == "range":
        return rng.integers(0, 8001, n).astype(dtype)
    if kind == "hash":
        keys = rng.integers(0, 1 << 62, n, dtype=np.int64)
        keys[rng.random(n) < 0.1] = np.iinfo(np.int64).max
        return keys
    if kind == "low0":
        info = np.iinfo(dtype)
        return (rng.integers(info.min >> 16, info.max >> 16, n,
                             endpoint=True) << 16).astype(dtype)
    if kind == "const":
        return np.full(n, -5, dtype)
    if kind == "ties":
        return np.array([-1, 0, 7], dtype)[rng.integers(0, 3, n)]
    if kind == "markers":
        lane = np.arange(n, dtype=np.int32)
        return np.where(rng.random(n) < 0.2, lane, I32_MAX).astype(dtype)
    if kind == "skew":
        keys = _keys(rng, dtype, n, "random")
        keys[rng.random(n) < 0.95] = 4242
        return keys
    return _keys(rng, dtype, n, kind)


def _radix_payload(rng, n, kind):
    if kind in ("iota", "hash"):
        return np.arange(n, dtype=np.int32)
    if kind == "nondec":
        return (np.arange(n) // 7 - 100).astype(np.int32)
    if kind == "const":
        return np.full(n, 3, np.int32)
    if kind == "markers":
        return rng.integers(1, 1 << 23, n).astype(np.int32)
    return _payload(rng, n, "random")


def _radix_case(inst, n, kind, seed):
    def build():
        dtype, with_pay = INSTANCES[inst]
        rng = np.random.default_rng(seed)
        keys = _radix_keys(rng, dtype, n, kind)
        return keys, (_radix_payload(rng, n, kind) if with_pay else None)
    return build


def _radix_cases():
    """name -> (case maker, number of passes).  Key passes: one a
    varying key byte (8 or 4; 2 for [0, 8000], 2 fewer for multiples of
    2^16, none for constant keys); payload passes: one a varying payload
    byte when the payload decreases somewhere (4 for a random payload,
    3 for run lengths below 2^23), none for an iota or nondecreasing
    one."""
    cases, seed = {}, 1000
    t = RADIX_TILE
    for inst, (dtype, with_pay) in INSTANCES.items():
        kd = np.dtype(dtype).itemsize
        rows = [("range", t + 1, 2), ("range", (1 << 17) + 5, 2),
                ("low0", t + 1, kd - 2), ("const", t + 1, 0),
                ("const", 1, 0), ("random", t - 1, kd),
                ("random", t, kd), ("random", 3 * t + 1, kd),
                ("skew", 5 * t + 11, kd)]
        if kd == 8:
            rows.append(("hash", (1 << 17) + 5, 8))
        if with_pay:
            rows += [("iota", t + 1, kd), ("nondec", 3 * t + 1, kd),
                     ("ties", 3 * t + 1, 4 + kd)]
            # the random payload of the other kinds adds its 4 passes
            rows = [(k, n, p + (4 if k in ("range", "low0", "random",
                                           "skew") else 0))
                    for k, n, p in rows]
        if inst == "i32_i32":
            rows.append(("markers", (1 << 17) + 5, 3 + 4))
        for kind, n, passes in rows:
            seed += 1
            cases[f"{inst}_{kind}_{n}"] = (_radix_case(inst, n, kind, seed),
                                           passes)
    return cases


RADIX_CASES = _radix_cases()
# name -> number of passes of the kernel's plan
RADIX_PASSES = {name: passes for name, (_b, passes) in RADIX_CASES.items()}
# name -> case maker
CASES = dict(_cases(), **{name: build
                          for name, (build, _p) in RADIX_CASES.items()})


def expected(keys, payload):
    """The contract in plain numpy: the lanes in ascending order of
    (key, payload)."""
    if payload is None:
        return np.sort(keys, kind="stable"), None
    order = np.lexsort((payload, keys))
    return keys[order], payload[order]
