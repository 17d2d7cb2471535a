"""Streaming FASTA/FASTQ reader (host side, numpy).

Port of `yak_tpu/io/fasta.py`: the functional replacement for the
reference's kseq front-end (bseq.c, kseq.h), gzip-capable, `-` = stdin.
Records carry their bases as bytes; `FastxRecord.codes` maps them to
2-bit codes (4 = N) for the chunk packer (`io/pack.py`).
"""

import gzip
import io
import sys

import numpy as np

from yak_tpu_torch.ops.encode import NT4_TABLE


def _open_raw(path):
    if path == "-" or path is None:
        raw = sys.stdin.buffer
    else:
        raw = open(path, "rb")
    head = raw.peek(2) if hasattr(raw, "peek") else b""
    if len(head) >= 2 and head[0] == 0x1F and head[1] == 0x8B:
        return gzip.open(raw, "rb")
    if not hasattr(raw, "peek"):
        # stdin without peek: buffer it
        raw = io.BufferedReader(raw)
        head = raw.peek(2)
        if len(head) >= 2 and head[0] == 0x1F and head[1] == 0x8B:
            return gzip.open(raw, "rb")
    return raw


class FastxRecord:
    __slots__ = ("name", "seq", "qual", "comment")

    def __init__(self, name, seq, qual=None, comment=None):
        self.name = name
        self.seq = seq
        self.qual = qual
        self.comment = comment

    @property
    def codes(self):
        return NT4_TABLE[np.frombuffer(self.seq, dtype=np.uint8)]


class FastxReader:
    """Iterate FASTA/FASTQ records from a (possibly gzipped) file."""

    def __init__(self, path):
        self._fp = _open_raw(path)
        self._pushback = None

    def __iter__(self):
        return self

    def _readline(self):
        if self._pushback is not None:
            line, self._pushback = self._pushback, None
            return line
        return self._fp.readline()

    def __next__(self):
        # seek to header
        while True:
            line = self._readline()
            if not line:
                raise StopIteration
            line = line.rstrip(b"\r\n")
            if line.startswith(b">") or line.startswith(b"@"):
                break
        is_fq = line.startswith(b"@")
        fields = line[1:].split(None, 1)
        name = fields[0].decode() if fields else ""
        comment = fields[1].decode() if len(fields) > 1 else None
        seq_parts = []
        qual = None
        if not is_fq:
            while True:
                line = self._fp.readline()
                if not line:
                    break
                if line.startswith(b">") or line.startswith(b"@"):
                    self._pushback = line
                    break
                seq_parts.append(line.strip())
        else:
            while True:
                line = self._fp.readline()
                if not line or line.startswith(b"+"):
                    break
                seq_parts.append(line.strip())
            seq = b"".join(seq_parts)
            qparts = []
            qlen = 0
            while qlen < len(seq):
                line = self._fp.readline()
                if not line:
                    break
                q = line.strip()
                qparts.append(q)
                qlen += len(q)
            qual = b"".join(qparts)
            return FastxRecord(name, seq, qual, comment)
        return FastxRecord(name, b"".join(seq_parts), None, comment)

    def close(self):
        if self._fp is not sys.stdin.buffer:
            self._fp.close()

