"""Chunk source: the Python FASTA/Q reader feeding the chunk packer.

Port of `yak_tpu/io/chunks.py` over the Python reader only; it yields
the same PackedChunks as the JAX package's `YAK_TPU_NO_NATIVE=1` path.
The native C++ reader (`yak_tpu/native/fastx.cpp`, built by path) is a
later step of the port (ROADMAP Queue 1 step 2).
"""

from yak_tpu_torch.io.fasta import FastxReader
from yak_tpu_torch.io.pack import pack_records


class ChunkSource:
    """Iterable of PackedChunks over one file; exposes n_seq after
    exhaustion (the per-file sequence tally used by count's log line)."""

    def __init__(self, path, chunk_size, k, min_len=0, with_meta=True):
        self._n_seq = 0
        self._reader = FastxReader(path)
        self._chunk_size = chunk_size
        self._k = k
        self._min_len = min_len
        self._with_meta = with_meta

    def __iter__(self):
        def recs():
            for rec in self._reader:
                if len(rec.seq) < self._min_len:
                    continue
                self._n_seq += 1
                yield rec

        yield from pack_records(recs(), self._chunk_size, self._k,
                                with_meta=self._with_meta)
        self._reader.close()

    @property
    def n_seq(self):
        return self._n_seq

    def close(self):
        self._reader.close()
