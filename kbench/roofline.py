"""Byte bounds of the program's memory-bound kernels on one H100: the
bytes a call must move, each counted once, over the device memory
rate.  The rules are the ones `chip_smoke.py` times the kernels
against, copied here so that the benchmark's yardstick cannot move:

- merge-reduce: `chip_smoke.merge_bound_ms` (chip_smoke.py:562-574);
- JOIN: the bound of `lookup_phase` (chip_smoke.py:1014-1017).

Each takes a call's sizes as plain integers and returns its bytes;
`seconds` gives their time at the device memory rate.
"""

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA's data sheet


def merge_bytes(live, batch_valid, new_size, cap, weighted):
    """One merge-reduce call: the live table's keys and counts read
    (12 B a slot), the valid batch keys read (8 B, and 4 B more for
    a weight), the surviving keys and counts written (12 B)."""
    per_lane = 12 if weighted else 8
    return 12 * min(live, cap) + per_lane * batch_valid \
        + 12 * min(new_size, cap)


def join_bytes(live, n_queries):
    """One JOIN call: the live table's keys and counts read once, each
    query's key and lane read and its value written (16 B)."""
    return 12 * live + 16 * n_queries


def seconds(nbytes):
    return nbytes / HBM_BYTES_PER_S
