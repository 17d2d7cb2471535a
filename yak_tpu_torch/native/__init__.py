"""The native (C++) host runtime: the FASTA/Q reader and chunk packer, and
the khashl layout simulator of the byte-exact dump, bound with ctypes.

Port of `yak_tpu/native/__init__.py` over the package's own copies of
its two sources (`fastx.cpp`, `khlayout.cpp`, unchanged): `fastx.cpp`
parses FASTA/FASTQ (gzip or plain) on a background thread and packs the
fixed-shape chunks of `io/pack.py`, bit planes included, while the
device folds the previous ones (`NativePackReader`, what
`io/chunks.ChunkSource` takes when it can); `khlayout.cpp` replays the
reference's insert protocol for `io/exactdump.py` (`KhashlLayout`).

The library is built by g++ at its first use, never at import, into
`build/yak_tpu_torch/` at the repository root, named by the hash of the
sources and the flags: a changed source builds anew, an unchanged one
loads the library already built.  The build writes a temporary file and
renames it into place, so a process never loads a half-written library
while another builds it.  A failed build prints a warning and the
readers take the Python path (`available()` is then False);
`YAK_TPU_NO_NATIVE` set to anything keeps the Python reader too.  The
simulator has no Python path: `KhashlLayout` raises without the library.
"""

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from yak_tpu_torch.ops.cuda_build import BUILD_DIR

SRC_DIR = Path(__file__).resolve().parent
SOURCES = (SRC_DIR / "fastx.cpp", SRC_DIR / "khlayout.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-lz", "-lpthread")

_state = {"lib": None, "tried": False}


def library_path():
    """build/yak_tpu_torch/libyakfastx-<hash of sources and flags>.so"""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libyakfastx-{h.hexdigest()[:16]}.so"


def build():
    """Build the library if it is not there; returns its path.  Raises
    RuntimeError with the compiler's message when g++ fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, *map(str, SOURCES), *LIBS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ could not run: {e}") from e
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(res.stderr)
    os.replace(tmp, out)
    return out


def _bind(lib):
    lib.yx_open.restype = ctypes.c_void_p
    lib.yx_open.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                            ctypes.c_long, ctypes.c_int, ctypes.c_int]
    lib.yx_next.restype = ctypes.c_long
    lib.yx_next.argtypes = [ctypes.c_void_p]
    for name, res in [("yx_codes", ctypes.POINTER(ctypes.c_uint8)),
                      ("yx_seq_id", ctypes.POINTER(ctypes.c_int32)),
                      ("yx_pos", ctypes.POINTER(ctypes.c_int32)),
                      ("yx_plo", ctypes.POINTER(ctypes.c_uint32)),
                      ("yx_phi", ctypes.POINTER(ctypes.c_uint32)),
                      ("yx_pnn", ctypes.POINTER(ctypes.c_uint32)),
                      ("yx_meta_names", ctypes.c_char_p)]:
        getattr(lib, name).restype = res
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("yx_meta_n", "yx_plane_words", "yx_meta_names_len"):
        getattr(lib, name).restype = ctypes.c_long
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.yx_meta_fill.restype = None
    lib.yx_meta_fill.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_int64)] * 5
    lib.yx_n_seq.restype = ctypes.c_int64
    lib.yx_n_seq.argtypes = [ctypes.c_void_p]
    lib.yx_close.restype = None
    lib.yx_close.argtypes = [ctypes.c_void_p]
    # the khashl layout simulator (khlayout.cpp)
    lib.ykl_create.restype = ctypes.c_void_p
    lib.ykl_create.argtypes = [ctypes.c_int] * 4
    lib.ykl_count_file.restype = ctypes.c_long
    lib.ykl_count_file.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int]
    lib.ykl_clear_counts.restype = None
    lib.ykl_clear_counts.argtypes = [ctypes.c_void_p]
    lib.ykl_shrink.restype = None
    lib.ykl_shrink.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ykl_tot.restype = ctypes.c_int64
    lib.ykl_tot.argtypes = [ctypes.c_void_p]
    for name in ("ykl_shard_cap", "ykl_shard_size"):
        getattr(lib, name).restype = ctypes.c_uint32
        getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ykl_shard_keys.restype = ctypes.c_uint32
    lib.ykl_shard_keys.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_uint64)]
    lib.ykl_destroy.restype = None
    lib.ykl_destroy.argtypes = [ctypes.c_void_p]
    return lib


def _load():
    """The bound library, building it at the first call; None when
    YAK_TPU_NO_NATIVE is set or the build or load failed (a failure is
    reported once and not retried)."""
    if os.environ.get("YAK_TPU_NO_NATIVE"):
        return None
    if not _state["tried"]:
        _state["tried"] = True
        try:
            _state["lib"] = _bind(ctypes.CDLL(str(build())))
        except RuntimeError as e:
            print(f"[W::native] build failed, using Python reader:\n"
                  f"{str(e)[:500]}", file=sys.stderr)
        except OSError as e:
            print(f"[W::native] load failed, using Python reader: {e}",
                  file=sys.stderr)
    return _state["lib"]


def available():
    return _load() is not None


class KhashlLayout:
    """Host-side simulator of the reference insert protocol and khashl
    slot layout (khlayout.cpp): the within-shard key order of a
    reference `.yak` dump (htab.c:373-394), for the byte-exact dump
    (io/exactdump.py); the device table stays the source of truth for
    the contents."""

    def __init__(self, k, pre, bf_shift=0, bf_n_hash=4):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native library unavailable: the byte-exact dump needs "
                "its khashl simulator (unset YAK_TPU_NO_NATIVE; g++ and "
                "zlib build it)")
        self._lib = lib
        self.pre = int(pre)
        self._h = lib.ykl_create(int(k), int(pre), int(bf_shift),
                                 int(bf_n_hash))
        if not self._h:
            raise ValueError("bad khlayout parameters")

    def count_file(self, path, create_new=True):
        n = self._lib.ykl_count_file(self._h, str(path).encode(),
                                     1 if create_new else 0)
        if n < 0:
            raise FileNotFoundError(path)
        return int(n)

    def clear_counts(self):
        self._lib.ykl_clear_counts(self._h)

    def shrink(self, mn, mx):
        self._lib.ykl_shrink(self._h, int(mn), int(mx))

    @property
    def tot(self):
        return int(self._lib.ykl_tot(self._h))

    def shard(self, s):
        """(capacity, in-table file keys u64[size] in slot order)."""
        cap = int(self._lib.ykl_shard_cap(self._h, s))
        size = int(self._lib.ykl_shard_size(self._h, s))
        out = np.empty(size, np.uint64)
        if size:
            n = int(self._lib.ykl_shard_keys(
                self._h, s,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))))
            if n != size:
                raise RuntimeError(f"shard {s}: {n} keys of {size}")
        return cap, out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.ykl_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


class _LazyNames:
    """gid -> name over the ascending gid array and the '\n'-joined name
    blob, split at the first lookup (an eager dict a chunk costs more
    host time than the parse)."""

    __slots__ = ("_gids", "_blob", "_names")

    def __init__(self, gids, blob):
        self._gids, self._blob, self._names = gids, blob, None

    def _split(self):
        if self._names is None:
            self._names = self._blob.decode().split(
                "\n")[:len(self._gids)]
        return self._names

    def __getitem__(self, gi):
        i = int(np.searchsorted(self._gids, gi))
        if i >= len(self._gids) or self._gids[i] != gi:
            raise KeyError(gi)
        return self._split()[i]

    def items(self):
        return zip((int(g) for g in self._gids), self._split())

    def __iter__(self):
        return (int(g) for g in self._gids)

    def __len__(self):
        return len(self._gids)

    def __eq__(self, other):
        return dict(self.items()) == other

    __hash__ = None


class _LazyLens:
    """gid -> full record length over the ascending gid array."""

    __slots__ = ("_gids", "_lens")

    def __init__(self, gids, lens):
        self._gids, self._lens = gids, lens

    def __getitem__(self, gi):
        i = int(np.searchsorted(self._gids, gi))
        if i >= len(self._gids) or self._gids[i] != gi:
            raise KeyError(gi)
        return int(self._lens[i])

    def __len__(self):
        return len(self._gids)

    def items(self):
        return ((int(g), int(v)) for g, v in zip(self._gids, self._lens))

    def __eq__(self, other):
        return dict(self.items()) == other

    __hash__ = None


class _NativeChunk:
    """io.pack.PackedChunk's fields, copied out of the native chunk (which
    the next yx_next recycles), plus `planes`: the chunk's (plo, phi,
    pnn) bit planes, u32 [1, W], as io.pack.pack_planes gives them."""

    __slots__ = ("codes", "seq_id", "pos", "n_bases", "seq_names",
                 "seq_lens", "rec_gid", "rec_len", "rec_start", "rec_off0",
                 "rec_take", "planes")


class NativePackReader:
    """Iterate PackedChunk-like chunks of a FASTA/FASTQ path (gzip or
    plain; None or "-" reads stdin).

    min_len: drop records shorter than this before packing (count.c:94's
    `l < k` skip; 0 keeps every record).  with_meta: False (codes and
    planes only), "records" (the rec_* arrays, names and lengths) or
    True (also the per-position seq_id and pos)."""

    def __init__(self, path, chunk_size, k, min_len=0, with_meta=True,
                 n_buf=4):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._chunk_size = int(chunk_size)
        self._level = 0 if not with_meta else (
            1 if with_meta == "records" else 2)
        self._n_seq = 0
        p = "-" if path in (None, "-") else str(path)
        self._h = lib.yx_open(p.encode(), self._chunk_size, int(k),
                              int(min_len), self._level, int(n_buf))
        if not self._h:
            raise FileNotFoundError(p)

    def __iter__(self):
        return self

    def __next__(self):
        if self._h is None:
            raise StopIteration
        lib, h = self._lib, self._h
        n = lib.yx_next(h)
        if n < 0:
            self.close()
            raise StopIteration
        c = _NativeChunk()
        c.n_bases = int(n)
        cs = self._chunk_size
        c.codes = np.ctypeslib.as_array(lib.yx_codes(h), (cs,)).copy()
        W = int(lib.yx_plane_words(h))
        c.planes = tuple(
            np.ctypeslib.as_array(getattr(lib, f)(h), (W,))
            .reshape(1, W).copy()
            for f in ("yx_plo", "yx_phi", "yx_pnn"))
        c.seq_id = c.pos = None
        c.seq_names, c.seq_lens = {}, {}
        c.rec_gid = c.rec_len = c.rec_start = c.rec_off0 = c.rec_take = None
        if self._level >= 2:
            c.seq_id = np.ctypeslib.as_array(lib.yx_seq_id(h), (cs,)).copy()
            c.pos = np.ctypeslib.as_array(lib.yx_pos(h), (cs,)).copy()
        if self._level >= 1:
            m = int(lib.yx_meta_n(h))
            arrs = [np.empty(m, np.int64) for _ in range(5)]
            blob = b""
            if m:
                lib.yx_meta_fill(h, *[
                    a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
                    for a in arrs])
                blob = ctypes.string_at(lib.yx_meta_names(h),
                                        int(lib.yx_meta_names_len(h)))
            gids, lens, starts, off0s, takes = arrs
            c.rec_gid, c.rec_len = gids, lens
            c.rec_start, c.rec_off0, c.rec_take = starts, off0s, takes
            c.seq_names = _LazyNames(gids, blob)
            c.seq_lens = _LazyLens(gids, lens)
        return c

    @property
    def n_seq(self):
        """Records accepted so far (the parser thread's count; final
        once the reader is exhausted)."""
        return int(self._lib.yx_n_seq(self._h)) if self._h else self._n_seq

    def close(self):
        if getattr(self, "_h", None) is not None:
            self._n_seq = int(self._lib.yx_n_seq(self._h))
            self._lib.yx_close(self._h)
            self._h = None

    def __del__(self):
        self.close()
