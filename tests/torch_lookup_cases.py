"""Seeded inputs of the lookup workloads (qv, chkerr) for the port's CPU
parity tests (tests/test_torch_qv.py, tests/test_torch_chkerr.py).

numpy only.  At the smallest device chunk (CHUNK = 16384 bases):

- reads.fq: fixed-length reads (READ_LEN + 1 = 128 divides the chunk,
  so every chunk takes the periodic 2-plane layout) with 1 % errors;
  the count table of the workloads is built from it;
- contigs.fa: multi-line FASTA of the same genome (the general 3-plane
  layout): contigs that span two and three chunks, one with a novel
  3,000-base stretch across the first chunk edge (a low-count run that
  crosses it), N runs, lowercase bases, sequences shorter than k, and
  1 % substitutions.
"""

import numpy as np

ALPH = np.frombuffer(b"ACGT", np.uint8)
READ_LEN = 127
CHUNK = 16384
GENOME_LEN = 12000


def _genome(rng):
    return rng.integers(0, 4, GENOME_LEN)


def write_reads(path, seed=2025, n=700):
    rng = np.random.default_rng(seed)
    g = _genome(rng)
    with open(path, "wb") as f:
        for i in range(n):
            s = rng.integers(0, len(g) - READ_LEN)
            r = g[s:s + READ_LEN].copy()
            m = rng.random(READ_LEN) < 0.01
            r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
            if rng.random() < 0.5:
                r = (3 - r)[::-1]
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, ALPH[r].tobytes(),
                                              b"I" * READ_LEN))


def _wrap(seq, width=60):
    return b"".join(seq[j:j + width] + b"\n"
                    for j in range(0, len(seq), width))


def write_contigs(path, seed=2025):
    rng = np.random.default_rng(seed)
    g = _genome(rng)       # the same genome as write_reads(seed)
    rng = np.random.default_rng(seed + 1)

    def piece(n):
        s = int(rng.integers(0, len(g) - n))
        return g[s:s + n].copy()

    seqs = [
        # novel stretch across the first chunk edge, then genome again
        np.concatenate([g[:10000], piece(5000)[:5000],
                        rng.integers(0, 4, 3000), g[2000:9000]]),
        np.concatenate([g, g[:9000], g[3000:]]),     # spans three chunks
    ]
    for _ in range(60):
        seqs.append(piece(int(rng.integers(5, 1500))))   # some < k
    seqs.insert(20, np.concatenate([g[4000:], g[:8000]]))  # spans two
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            m = rng.random(len(s)) < 0.01
            s[m] = (s[m] + rng.integers(1, 4, int(m.sum()))) % 4
            b = ALPH[s].copy()
            if len(s) > 80 and i % 3 == 0:
                b[rng.integers(0, len(s) - 30):][:25] = ord("N")
            if len(s) > 40 and i % 4 == 1:
                b[rng.integers(0, len(s), 2)] = ord("n")
                b[rng.integers(0, len(s), 3)] = ord("a")
            f.write(b">ctg%d len=%d\n" % (i, len(s)) + _wrap(b.tobytes()))
