"""Seeded inputs of the trio workloads (triobin, trioeval) for the port's
CPU parity tests (tests/test_torch_trio.py, tests/test_torch_wide_lookup.py).

numpy only.  One small genome, two haplotypes of it:

- pat: the genome with its own substitutions (one every ~250 bases) and
  a pat-only insertion of PAT_INS random bases, longer than a chunk;
- mat: the genome with other substitutions and a mat-only insertion;

each sequenced as FASTQ reads (1 % errors, both strands) that
`yak_tpu` counts into the pat and mat tables; the pat insertion is also
tiled by error-free reads, so that all of its k-mers are pat-strong.
The child FASTA at the smallest device chunk (CHUNK = 16384 bases):
contigs of either haplotype and recombinants that cross chunk edges;
ctg0, the pat haplotype's first 34,000 bases unaltered, whose
insertion spans a whole chunk as one piece and one run of type 1 (the
`single and nseq == 1` branch of `_TriobinFold.chunk`); the other
contigs with substitutions, contigs shorter than k, N runs and
lowercase bases.
"""

import numpy as np

ALPH = np.frombuffer(b"ACGT", np.uint8)
CHUNK = 16384
GENOME_LEN = 24_000
PAT_INS = 18_000            # longer than a chunk
MAT_INS = 3_000
READ_LEN = 127
COVERAGE = 8


PAT_INS_AT = 15_000


def haplotypes(seed=9):
    """(pat, mat) base arrays, and the genome they come from."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, GENOME_LEN)
    haps = []
    for ins_len, at in ((PAT_INS, PAT_INS_AT), (MAT_INS, 6_000)):
        h = g.copy()
        pos = np.sort(rng.choice(GENOME_LEN, GENOME_LEN // 250,
                                 replace=False))
        h[pos] = (h[pos] + rng.integers(1, 4, len(pos))) % 4
        haps.append(np.concatenate([h[:at], rng.integers(0, 4, ins_len),
                                    h[at:]]))
    return haps[0], haps[1], g


def write_reads(path, hap, seed, tile=None):
    """COVERAGE-fold random reads of `hap` with 1 % errors; `tile`, a
    (start, end) range of `hap`, adds error-free reads every 16 bases
    over it, so that each of its k-mers is counted at least 5 times."""
    rng = np.random.default_rng(seed)
    starts = list(rng.integers(0, len(hap) - READ_LEN,
                               COVERAGE * len(hap) // READ_LEN))
    n_random = len(starts)
    if tile is not None:
        starts += range(tile[0] - READ_LEN, tile[1], 16)
    with open(path, "wb") as f:
        for i, s in enumerate(starts):
            r = hap[s:s + READ_LEN].copy()
            m = rng.random(READ_LEN) < (0.01 if i < n_random else 0)
            r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
            if rng.random() < 0.5:
                r = (3 - r)[::-1]
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, ALPH[r].tobytes(),
                                              b"I" * READ_LEN))


def _wrap(seq, width=60):
    return b"".join(seq[j:j + width] + b"\n"
                    for j in range(0, len(seq), width))


def child_contigs(seed=9):
    """The child's contigs as base-code arrays (4 = N)."""
    pat, mat, g = haplotypes(seed)
    rng = np.random.default_rng(seed + 1)

    def piece(h, n):
        s = int(rng.integers(0, len(h) - n))
        return h[s:s + n].copy()

    seqs = [
        # the pat-only insertion, [15000, 33000) of pat, spans chunk 1
        # whole (the stream's bases [16384, 32768))
        pat[:34_000].copy(),
        np.concatenate([pat[:9_000], mat[9_000:20_000]]),   # recombinant
        mat.copy(),                                          # two chunks
        piece(g, 20),                                        # shorter than k
        np.concatenate([mat[2_000:7_000], pat[30_000:36_000]]),
    ]
    for _ in range(30):
        h = pat if rng.random() < 0.5 else mat
        seqs.append(piece(h, int(rng.integers(5, 1200))))
    seqs.insert(12, np.concatenate([mat[:12_000], pat[20_000:31_000]]))
    for i, s in enumerate(seqs[1:], 1):
        m = rng.random(len(s)) < 0.002
        s[m] = (s[m] + rng.integers(1, 4, int(m.sum()))) % 4
        if len(s) > 200 and i % 3 == 1:
            s[rng.integers(0, len(s) - 60):][:40] = 4
    return seqs


def write_child(path, seed=9):
    rng = np.random.default_rng(seed + 2)
    alph = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as f:
        for i, s in enumerate(child_contigs(seed)):
            b = alph[s].copy()
            if len(s) > 40 and i % 4 == 2:
                j = rng.integers(0, len(s), 5)
                b[j] = np.where(b[j] != ord("N"), b[j] + 32, b[j])
            f.write(b">ctg%d len=%d\n" % (i, len(s)) + _wrap(b.tobytes()))
