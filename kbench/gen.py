"""The one generator of the benchmark's inputs: a genome, reads sampled
from it and contigs cut from it, all made from the run's seed on the
device by one torch.Generator, in a few large calls.

The reads follow bench.py's model (uniform starts, substitutions, half
of them reverse-complemented); the contigs tile the genome once, their
lengths one fixed set drawn from the configuration (so every seed gives
the same work), in an order and with errors and strands drawn from the
seed.  Text (FASTQ, FASTA) is laid out on the device and copied to the
host once.
"""

import numpy as np
import torch

ACGT = b"ACGT"
BLOCK_ROWS = 1 << 20        # reads made at a time (bounds the set-up peak)


def generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def genome(g, n_bp, device):
    """Uniform random bases, uint8 codes 0..3."""
    return torch.randint(0, 4, (n_bp,), generator=g, device=device,
                         dtype=torch.uint8)


def reads(g, bases, n_reads, read_len, sub_rate, rc_frac):
    """n_reads reads of read_len bases of `bases` at uniform starts, each
    base substituted with probability sub_rate, each read
    reverse-complemented with probability rc_frac: uint8 [n, read_len]."""
    dev = bases.device
    out = torch.empty((n_reads, read_len), dtype=torch.uint8, device=dev)
    span = torch.arange(read_len, device=dev)
    for r0 in range(0, n_reads, BLOCK_ROWS):
        n = min(BLOCK_ROWS, n_reads - r0)
        start = torch.randint(0, bases.numel() - read_len + 1, (n, 1),
                              generator=g, device=dev)
        r = bases[start + span]
        sub = torch.rand((n, read_len), generator=g, device=dev) < sub_rate
        shift = torch.randint(1, 4, (n, read_len), generator=g, device=dev,
                              dtype=torch.uint8)
        r = torch.where(sub, (r + shift) % 4, r)
        rc = torch.rand((n, 1), generator=g, device=dev) < rc_frac
        out[r0:r0 + n] = torch.where(rc, (3 - r).flip(1), r)
    return out


def contig_lengths(n_bp, lo, hi, seed):
    """The fixed contig lengths of a genome of n_bp: log-uniform in
    [lo, hi] from `seed` (the configuration's, not the run's) until the
    genome is covered, the last one cut to what is left."""
    rng = np.random.default_rng(seed)
    out, left = [], n_bp
    while left > 0:
        n = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        out.append(min(n, left))
        left -= out[-1]
    return out


def contigs(g, bases, lengths, sub_rate, rc_frac):
    """`bases` cut into contigs of `lengths` (a permutation of them
    drawn from g, laid end to end), substitutions at sub_rate, each
    reverse-complemented with probability rc_frac: a list of uint8
    code tensors in output order."""
    dev = bases.device
    order = torch.randperm(len(lengths), generator=g, device=dev).tolist()
    sub = torch.rand(bases.numel(), generator=g, device=dev) < sub_rate
    shift = torch.randint(1, 4, (bases.numel(),), generator=g, device=dev,
                          dtype=torch.uint8)
    seq = torch.where(sub, (bases + shift) % 4, bases)
    rc = (torch.rand(len(lengths), generator=g, device=dev)
          < rc_frac).tolist()
    out, off = [], 0
    for i in order:
        c = seq[off:off + lengths[i]]
        off += lengths[i]
        out.append((3 - c).flip(0) if rc[len(out)] else c)
    return out


def fastq(codes, name_digits=9):
    """FASTQ text of equal-length reads: `@r<index>` names of fixed width,
    constant quality 'I'.  uint8 [n, L] codes -> host bytes (numpy)."""
    n, length = codes.shape
    dev = codes.device
    head = 2 + name_digits + 1
    width = head + length + 3 + length + 1
    lut = torch.tensor(list(ACGT), dtype=torch.uint8, device=dev)
    out = np.empty(n * width, dtype=np.uint8)
    powers = 10 ** torch.arange(name_digits - 1, -1, -1, device=dev)
    for r0 in range(0, n, BLOCK_ROWS):
        m = min(BLOCK_ROWS, n - r0)
        rec = torch.empty((m, width), dtype=torch.uint8, device=dev)
        idx = torch.arange(r0, r0 + m, device=dev)[:, None]
        rec[:, 0] = ord("@")
        rec[:, 1] = ord("r")
        rec[:, 2:2 + name_digits] = ((idx // powers) % 10 + ord("0")).to(
            torch.uint8)
        rec[:, head - 1] = ord("\n")
        rec[:, head:head + length] = lut[codes[r0:r0 + m].long()]
        q = head + length
        rec[:, q] = ord("\n")
        rec[:, q + 1] = ord("+")
        rec[:, q + 2] = ord("\n")
        rec[:, q + 3:q + 3 + length] = ord("I")
        rec[:, width - 1] = ord("\n")
        out[r0 * width:(r0 + m) * width] = rec.reshape(-1).cpu().numpy()
    return out


def fasta(seqs, names):
    """One-line FASTA text of `seqs` (uint8 code tensors) named `names`,
    as host bytes."""
    parts = []
    for name, c in zip(names, seqs):
        parts.append(f">{name}\n".encode())
        parts.append(np.frombuffer(ACGT, np.uint8)[c.cpu().numpy()]
                     .tobytes())
        parts.append(b"\n")
    return b"".join(parts)
