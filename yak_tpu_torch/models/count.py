"""The `count` workload: stream sequences -> k-mer hashes -> counting
table (count.c:147-166), `recount` (count.c:168-193), and the Bloom
two-pass `-b` protocol (main.c:53-60).

Port of `yak_tpu/models/count.py`: the reader packs fixed-shape flat
code chunks and their bit planes (io/chunks.py, the native reader's
background thread where it builds) and the table folds them on its
device; CUDA queues device work asynchronously, so the host reads the
next chunks while the device folds the previous group.  `exact` (-X)
takes the serial-exact Bloom gate, for the byte-exact dump of
io/exactdump.py.
"""

import os
import sys
from dataclasses import dataclass, replace

from yak_tpu_torch import spans
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
    bf_n_hash: int = 4
    n_thread: int = 4          # accepted for CLI parity; unused
    chunk_size: int = 10_000_000
    cap_log2: int = 16         # initial table capacity (grows amortized)
    # -X: the serial-exact Bloom gate (htab.c:57-70 bit for bit), so
    # that the pass-1 key set is the reference's even when pass 2 reads
    # another file, as the byte-exact dump's replay needs
    exact: bool = False
    device: str = "cuda"


def _device_chunk(opt):
    # fixed flat-buffer size: one fold shape for the whole run
    c = max(1 << 14, min(int(opt.chunk_size), 1 << 23))
    return -(-c // 1024) * 1024


def count_file(fn, opt, table=None):
    """Count k-mers of one file into `table` (created on opt.device, with
    the Bloom filter of opt.bf_shift/opt.bf_n_hash, if None).

    table=None -> create-new mode; otherwise increment-existing-only
    (the pass-2 / recount path, htab.c:71-75).
    """
    create_new = table is None
    if table is None:
        table = KmerTable(opt.k, opt.pre, cap_log2=opt.cap_log2,
                          device=opt.device, bf_shift=opt.bf_shift,
                          bf_n_hash=opt.bf_n_hash, bf_exact=opt.exact)
    elif table.k != opt.k or table.pre != opt.pre:
        raise ValueError("count_file: table k/pre differ from the options")
    chunk = _device_chunk(opt)
    # record-level meta lets the periodic-layout check run on metadata
    src = ChunkSource(fn, chunk, opt.k, min_len=opt.k,  # count.c:94 skip
                      with_meta="records")
    prog = Progress("count_file")
    for packed in src:
        # the host's work on a chunk (a fold, where the chunk completes a
        # group, nests its own spans)
        with spans.span("count.chunk"):
            per = detect_periodic_meta(packed)
            table.insert_codes(packed.codes, create_new=create_new,
                               planes=getattr(packed, "planes", None),
                               periodic=per if per else False)
        # per-chunk line (count.c:140-141 shape); the distinct-k-mer
        # figure is the last SETTLED fold (syncing here would stall)
        prog.line(f"processed {src.n_seq} sequences; {table._tot} "
                  f"distinct k-mers in the hash table")
    prog.line(f"processed {src.n_seq} sequences; {table.tot} distinct "
              f"k-mers in the hash table")
    return table


def _same_stream(a, b):
    """Whether the two -b pass inputs are the same file: the same path,
    or the same real path (models/count._same_stream)."""
    if a == b:
        return True
    try:
        return os.path.realpath(a) == os.path.realpath(b)
    except OSError:
        return False


def literal_two_pass(files, opt):
    """Whether `count` runs the literal -b protocol over `files`: -b is
    given and the same-file shortcut does not apply (see count)."""
    second = files[1] if len(files) >= 2 else files[0]
    return opt.bf_shift > 0 and not (
        _same_stream(files[0], second)
        and not os.environ.get("YAK_TPU_BLOOM_TWO_PASS"))


def count(files, opt):
    """Full `yak count` semantics including the `-b` two-pass protocol
    (main.c:53-60): pass 1 Bloom-gated; destroy the filter, zero the
    counts; pass 2 over the second input (or the first again) increments
    existing keys; shrink to counts >= 2.

    Same-file shortcut, as in the JAX package (YAK_TPU_BLOOM_TWO_PASS set
    to anything forces the literal protocol): when both passes read the
    same path, the protocol's table is exactly {key: count | count >= 2}
    (a key's second sighting always passes the gate, pass 2 recounts
    every sighting of every admitted key, and the shrink drops the
    gate's false positives), so one ungated pass + shrink gives it.  The
    test is on paths, not content: two paths to the same data take the
    literal protocol, whose table is the same."""
    if opt.bf_shift <= 0:
        return count_file(files[0], opt)
    if not literal_two_pass(files, opt):
        table = count_file(files[0], replace(opt, bf_shift=0))
    else:
        table = count_file(files[0], opt)
        with spans.span("count.switch"):
            table.destroy_bf()
            table.clear_counts()
        count_file(files[1] if len(files) >= 2 else files[0], opt,
                   table=table)
    table.shrink(2, 1023)
    print(f"[M::count] {table.tot} distinct k-mers after shrinking",
          file=sys.stderr)
    return table


def recount(fn, table):
    """Zero the counts, then count only the table's own keys over `fn`
    (yak_recount): increment-only folds (the merge-reduce with
    create=False; k >= 32 through its wide mode).  As in the JAX
    package, sequences shorter than k are not skipped here (they give
    no window)."""
    table.clear_counts()
    chunk = _device_chunk(CountOpts(k=table.k, pre=table.pre))
    for packed in ChunkSource(fn, chunk, table.k, with_meta="records"):
        per = detect_periodic_meta(packed)
        table.insert_codes(packed.codes, create_new=False,
                           planes=getattr(packed, "planes", None),
                           periodic=per if per else False)
    table.flush()
    return table
