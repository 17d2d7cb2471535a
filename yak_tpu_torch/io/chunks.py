"""Chunk source: the native C++ reader when its library builds, the Python
reader and packer otherwise.

Port of `yak_tpu/io/chunks.py`.  Every workload consumes the same stream
of fixed-shape PackedChunks (io/pack.py for the layout); the native
reader (`native.NativePackReader`, `native/fastx.cpp`) parses and packs
on a background thread while the device works, and its chunks also
carry their bit planes (`planes`), which the folds and lookups upload
without packing on the host.  `force_python=True`, or YAK_TPU_NO_NATIVE
set to anything, takes the Python reader; both give the same chunks.
"""

from yak_tpu_torch import native
from yak_tpu_torch.io.fasta import FastxReader
from yak_tpu_torch.io.pack import pack_records


class ChunkSource:
    """Iterable of PackedChunks over one file; exposes n_seq after
    exhaustion (the per-file sequence tally of count's log line; 0
    until then on the native reader, as in the JAX package) and
    `reader`, "native" or "python", the reader it took."""

    def __init__(self, path, chunk_size, k, min_len=0, with_meta=True,
                 force_python=False):
        self._n_seq = 0
        self._native = None
        if not force_python and native.available():
            self._native = native.NativePackReader(
                path, chunk_size, k, min_len=min_len, with_meta=with_meta)
            return
        self._reader = FastxReader(path)
        self._chunk_size = chunk_size
        self._k = k
        self._min_len = min_len
        self._with_meta = with_meta

    @property
    def reader(self):
        return "python" if self._native is None else "native"

    def __iter__(self):
        if self._native is not None:
            yield from self._native
            self._n_seq = self._native.n_seq
            return

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
        if self._native is not None:
            self._native.close()
        else:
            self._reader.close()


def packed_chunks(path, chunk_size, k, min_len=0, with_meta=True,
                  force_python=False):
    return ChunkSource(path, chunk_size, k, min_len=min_len,
                       with_meta=with_meta, force_python=force_python)
