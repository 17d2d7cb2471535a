"""The `count` workload: stream sequences -> canonical k-mer hashes ->
counting table (count.c:147-166).

Port of `yak_tpu/models/count.py` without `-b`: the host packs
fixed-shape flat code chunks (io/pack.py) and the table folds them on
its device; CUDA queues device work asynchronously, so the host packs
the next chunks while the device folds the previous group.
"""

from dataclasses import dataclass

from yak_tpu_torch.io.chunks import ChunkSource
from yak_tpu_torch.io.pack import detect_periodic_meta
from yak_tpu_torch.table import KmerTable
from yak_tpu_torch.utils import Progress


@dataclass
class CountOpts:
    """Defaults per yak_copt_init (misc.c:23-32), plus the device."""
    k: int = 31
    pre: int = 10
    bf_shift: int = 0
    n_thread: int = 4          # accepted for CLI parity; unused
    chunk_size: int = 10_000_000
    cap_log2: int = 16         # initial table capacity (grows amortized)
    device: str = "cuda"


def _check_supported(opt):
    if opt.bf_shift > 0:
        raise NotImplementedError(
            "-b (the Bloom-filter two-pass count) is not yet ported: "
            "ROADMAP.md Queue 1, 'Bloom -b'")
    if opt.k >= 32:
        raise NotImplementedError(
            f"-k {opt.k}: k >= 32 (the hash_long wide path) is not yet "
            f"ported: ROADMAP.md Queue 1, 'k >= 32'")


def _device_chunk(opt):
    # fixed flat-buffer size: one fold shape for the whole run
    c = max(1 << 14, min(int(opt.chunk_size), 1 << 23))
    return -(-c // 1024) * 1024


def count_file(fn, opt, table=None):
    """Count k-mers of one file into `table` (created on opt.device if
    None).

    table=None -> create-new mode; otherwise increment-existing-only
    (the recount path, htab.c:71-75).
    """
    _check_supported(opt)
    create_new = table is None
    if table is None:
        table = KmerTable(opt.k, opt.pre, cap_log2=opt.cap_log2,
                          device=opt.device)
    elif table.k != opt.k or table.pre != opt.pre:
        raise ValueError("count_file: table k/pre differ from the options")
    chunk = _device_chunk(opt)
    # record-level meta lets the periodic-layout check run on metadata
    src = ChunkSource(fn, chunk, opt.k, min_len=opt.k,  # count.c:94 skip
                      with_meta="records")
    prog = Progress("count_file")
    for packed in src:
        per = detect_periodic_meta(packed)
        table.insert_codes(packed.codes, create_new=create_new,
                           periodic=per if per else False)
        # per-chunk line (count.c:140-141 shape); the distinct-k-mer
        # figure is the last SETTLED fold (syncing here would stall)
        prog.line(f"processed {src.n_seq} sequences; {table._tot} "
                  f"distinct k-mers in the hash table")
    prog.line(f"processed {src.n_seq} sequences; {table.tot} distinct "
              f"k-mers in the hash table")
    return table


def count(files, opt):
    """`yak count` without `-b`: the table of the first input (the
    second input is read only by the `-b` two-pass protocol)."""
    _check_supported(opt)
    return count_file(files[0], opt)
