"""Byte-exact `.yak` dumps (the reference's khashl slot order), for `-X`.

Port of `yak_tpu/io/exactdump.py`.  The one part of the `.yak` format
that io/yakfmt.py does not reproduce byte for byte is the order of the
keys within a shard: reference yak writes them in khashl slot order
(htab.c:373-394), an artifact of the order of insertion, where the
default dump writes them sorted (reference yak reads either the same).

For workflows that compare dump files byte for byte, the native
simulator (native/khlayout.cpp) replays the reference insert protocol
(canonical k-mer hashing, the shard split, the blocked Bloom gate,
khashl put and resize, the two-pass clear and shrink) over the original
input files on the host, which gives each shard's capacity and its keys
in slot order.  The device table stays the source of truth: the
simulator's (hash, count) multiset is checked against the table's, read
once, and a disagreement raises instead of writing a file that would
misstate where it came from.
"""

import struct
import sys

import numpy as np

from yak_tpu_torch import YAK_COUNTER_BITS, YAK_MAGIC, YAK_MAX_COUNT
from yak_tpu_torch.native import KhashlLayout


def simulate_layout(k, pre, files, bf_shift=0, bf_n_hash=4):
    """Replay the reference count protocol (main.c:53-60) on the host.

    files: the `count` positional arguments (one or two paths; with
    bf_shift > 0 the second pass reads files[1] if given, else files[0]).
    Returns a native.KhashlLayout holding the final per-shard layouts.
    """
    sim = KhashlLayout(k, pre, bf_shift=bf_shift, bf_n_hash=bf_n_hash)
    sim.count_file(files[0], create_new=True)
    if bf_shift > 0:
        sim.clear_counts()
        sim.count_file(files[1] if len(files) >= 2 else files[0],
                       create_new=False)
        sim.shrink(2, YAK_MAX_COUNT)
    return sim


def dump_yak_exact(path, table, files, bf_shift=0, bf_n_hash=4):
    """Write `table` (a KmerTable or a parallel.mesh.MeshTable) as a
    `.yak` file with the reference's bytes ("-" writes to stdout).

    Replays `files` through the khashl simulator, checks that the
    simulator and the table hold the same (hash, count) multiset, then
    writes the simulator's slot-ordered keys.  Raises ValueError on any
    disagreement.  bf_shift, bf_n_hash: the count options the table was
    built with (its own filter is gone by the end of the protocol)."""
    k, pre = table.k, table.pre
    sim = simulate_layout(k, pre, files, bf_shift=bf_shift,
                          bf_n_hash=bf_n_hash)
    try:
        caps, keyruns = zip(*(sim.shard(s) for s in range(1 << pre)))
    finally:
        sim.close()

    simkeys = np.concatenate(keyruns)
    shard = np.repeat(np.arange(1 << pre, dtype=np.uint64),
                      [len(r) for r in keyruns])
    sim_hash = ((simkeys >> np.uint64(YAK_COUNTER_BITS)) << np.uint64(pre)
                ) | shard
    sim_cnt = (simkeys & np.uint64(YAK_MAX_COUNT)).astype(np.int64)
    t_hash, t_cnt = table.items()
    t_hash = np.asarray(t_hash, np.uint64)
    t_cnt = np.asarray(t_cnt, np.int64) & YAK_MAX_COUNT
    so = np.argsort(sim_hash, kind="stable")
    to = np.argsort(t_hash, kind="stable")
    if not (len(sim_hash) == len(t_hash)
            and np.array_equal(sim_hash[so], t_hash[to])
            and np.array_equal(sim_cnt[so], t_cnt[to])):
        raise ValueError(
            "exact-dump cross-check failed: host replay and device table "
            f"disagree ({len(sim_hash)} vs {len(t_hash)} keys) — refusing "
            "to write a byte-exact dump that does not match the table")

    to_stdout = path == "-"
    fp = sys.stdout.buffer if to_stdout else open(path, "wb")
    try:
        fp.write(YAK_MAGIC)
        fp.write(struct.pack("<3I", k, pre, YAK_COUNTER_BITS))
        for cap, keys in zip(caps, keyruns):
            fp.write(struct.pack("<2I", cap, len(keys)))
            fp.write(keys.astype("<u8").tobytes())
    finally:
        if not to_stdout:
            fp.close()
