"""Exact `.yak` table file format (htab.c:373-481).

Layout:
  magic "YAK\\2" (4 bytes)
  u32 k, u32 pre, u32 counter_bits (= 10)
  for each of 2^pre shards, in order:
    u32 capacity, u32 size
    size x u64 in-table keys, key = ((hash >> pre) << 10) | count

The low `pre` bits of the hash are NOT stored; they are recovered from
the shard ordinal at load time (the shard index is positional).  This
module reads/writes that format byte-exactly so tables interoperate with
reference yak and hifiasm-era tooling.

Byte *order of keys within a shard* in reference-produced files is a
khashl slot-layout artifact (insertion-order dependent) with no behavioral
meaning; we write keys sorted ascending, which is deterministic and
topology-invariant.  Reference yak reads either order identically.

Port of `yak_tpu/io/yakfmt.py` (dump, restore, the streamed read of
`open_yak_stream`, load modes): a dump of the same table is
byte-identical from either package.
"""

import struct

import numpy as np

from yak_tpu_torch import (YAK_COUNTER_BITS, YAK_MAGIC, YAK_MAX_COUNT,
                     YAK_LOAD_ALL, YAK_LOAD_TRIOBIN1, YAK_LOAD_TRIOBIN2,
                     YAK_LOAD_SEXCHR1, YAK_LOAD_SEXCHR2, YAK_LOAD_SEXCHR3)


def _khashl_capacity(n):
    """Smallest power-of-two capacity satisfying khashl's 0.75 load bound."""
    cap = 4
    while n > cap - (cap >> 2):  # khashl upper bound: n_buckets - n_buckets/4
        cap <<= 1
    return cap


def dump_yak(path, k, pre, hashes, counts):
    """Write full (hash, count) pairs as a `.yak` file.

    hashes: uint64 array of full hashes (low `pre` bits = shard).
    counts: int array; low YAK_COUNTER_BITS bits are stored.
    """
    hashes = np.asarray(hashes, np.uint64)
    counts = np.asarray(counts, np.int64)
    shard = (hashes & np.uint64((1 << pre) - 1)).astype(np.int64)
    filekey = ((hashes >> np.uint64(pre)) << np.uint64(YAK_COUNTER_BITS)) | (
        counts.astype(np.uint64) & np.uint64(YAK_MAX_COUNT))
    order = np.lexsort((filekey, shard))
    shard = shard[order]
    filekey = filekey[order]
    # per-shard extents
    nsh = 1 << pre
    sizes = np.bincount(shard, minlength=nsh).astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    import sys

    to_stdout = path == "-"
    fp = sys.stdout.buffer if to_stdout else open(path, "wb")
    try:
        fp.write(YAK_MAGIC)
        fp.write(struct.pack("<3I", k, pre, YAK_COUNTER_BITS))
        for s in range(nsh):
            sz = int(sizes[s])
            fp.write(struct.pack("<2I", _khashl_capacity(sz), sz))
            fp.write(filekey[offs[s]:offs[s + 1]].tobytes())
    finally:
        if not to_stdout:
            fp.close()


def _read_header(fp, path):
    """(k, pre) of an open `.yak` file, after checking its magic and
    counter bits."""
    if fp.read(4) != YAK_MAGIC:
        raise ValueError(f"{path}: wrong file magic")
    k, pre, cbits = struct.unpack("<3I", fp.read(12))
    if cbits != YAK_COUNTER_BITS:
        raise ValueError(
            f"{path}: saved counter bits {cbits} != {YAK_COUNTER_BITS}")
    return int(k), int(pre)


def open_yak_stream(path, batch_keys=1 << 22):
    """Stream a `.yak` file in O(batch) host memory (two-table inspect's
    shard-by-shard read, inspect.c:40-62, in batches of batch_keys).

    Returns (k, pre, batches): `batches` yields (hashes u64[<=
    batch_keys], counts i32) in file order, every batch but the last
    exactly batch_keys long, with the full hashes rebuilt as
    (key >> counter_bits) << pre | shard.  The file is closed when the
    batches are exhausted or closed."""
    fp = open(path, "rb")
    try:
        k, pre = _read_header(fp, path)
    except BaseException:
        fp.close()
        raise

    def batches():
        with fp:
            hs, cs, n = [], [], 0
            for s in range(1 << pre):
                _cap, sz = struct.unpack("<2I", fp.read(8))
                left = sz
                while left:
                    m = min(left, batch_keys - n)
                    buf = np.frombuffer(fp.read(8 * m), dtype="<u8")
                    left -= m
                    hs.append(((buf >> np.uint64(YAK_COUNTER_BITS))
                               << np.uint64(pre)) | np.uint64(s))
                    cs.append((buf & np.uint64(YAK_MAX_COUNT))
                              .astype(np.int32))
                    n += m
                    if n == batch_keys:
                        yield np.concatenate(hs), np.concatenate(cs)
                        hs, cs, n = [], [], 0
            if n:
                yield np.concatenate(hs), np.concatenate(cs)

    return k, pre, batches()


def restore_yak(path):
    """Read a `.yak` file; returns (k, pre, hashes u64[N], counts i32[N]).

    hashes are the reconstructed *full* hashes:
      hash = (filekey >> counter_bits) << pre | shard_ordinal
    (the inverse of the dump transform; see htab.c:396-476 and the shard
    recovery also required by two-table inspect, SURVEY.md §2.1).
    """
    with open(path, "rb") as fp:
        k, pre = _read_header(fp, path)
        all_keys = []
        all_shards = []
        for s in range(1 << pre):
            _cap, sz = struct.unpack("<2I", fp.read(8))
            buf = np.frombuffer(fp.read(8 * sz), dtype="<u8")
            if sz:
                all_keys.append(buf)
                all_shards.append(np.full(sz, s, np.uint64))
    if all_keys:
        keys = np.concatenate(all_keys)
        shards = np.concatenate(all_shards)
    else:
        keys = np.zeros(0, np.uint64)
        shards = np.zeros(0, np.uint64)
    hashes = ((keys >> np.uint64(YAK_COUNTER_BITS)) << np.uint64(pre)) | shards
    counts = (keys & np.uint64(YAK_MAX_COUNT)).astype(np.int32)
    return int(k), int(pre), hashes, counts


def apply_load_mode(counts, mode, min_cnt=0, mid_cnt=0):
    """Transform restored counts per load mode (htab.c:449-470).

    Returns (values i32[N], keep bool[N]): `values` is the flag/count field
    to be OR-merged into the table; entries with keep=False are dropped
    (TRIOBIN below min_cnt).
    """
    counts = np.asarray(counts, np.int64)
    keep = np.ones(len(counts), bool)
    if mode == YAK_LOAD_ALL:
        vals = counts
    elif mode in (YAK_LOAD_TRIOBIN1, YAK_LOAD_TRIOBIN2):
        shift = 0 if mode == YAK_LOAD_TRIOBIN1 else 2
        cls = np.where(counts >= mid_cnt, 2, np.where(counts >= min_cnt, 1, -1))
        keep = cls >= 0
        vals = np.where(keep, cls << shift, 0)
    elif mode in (YAK_LOAD_SEXCHR1, YAK_LOAD_SEXCHR2, YAK_LOAD_SEXCHR3):
        shift = {YAK_LOAD_SEXCHR1: 0, YAK_LOAD_SEXCHR2: 1, YAK_LOAD_SEXCHR3: 2}[mode]
        vals = np.full(len(counts), 1 << shift, np.int64)
    else:
        raise ValueError(f"unknown load mode {mode}")
    return vals.astype(np.int32), keep
