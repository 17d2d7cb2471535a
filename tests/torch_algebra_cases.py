"""Seeded inputs of the table algebra, print, inspect and sexchr slice for
the port's CPU parity tests (tests/test_torch_algebra.py,
tests/test_torch_inspect.py, tests/test_torch_sexchr.py).

numpy only.  One small genome:

- two read sets of it as FASTQ (1 % errors, both strands; the second
  of a copy with its own substitutions), whose tables are the algebra's
  operands;
- assemblies: the genome as multi-line FASTA contigs with substitutions
  at a per-file spacing and offset, N runs and lowercase bases, so most
  k-mers occur once a file (cntasm's presence votes);
- the sexchr set: the genome's stretches [0, Y_END) as chrY, [Y_END,
  X_END) as chrX, [X_END, PAR_END) as PAR, the rest autosomal; hap1
  holds contigs of chrX, PAR and the autosomes, hap2 of chrY, PAR and
  the autosomes, both with substitutions, some longer than the
  smallest device chunk (CHUNK), so that they span chunks.
"""

import numpy as np

ALPH = np.frombuffer(b"ACGT", np.uint8)
CHUNK = 16384
GENOME_LEN = 40_000
READ_LEN = 101
Y_END, X_END, PAR_END = 9_000, 21_000, 24_000


def genome(seed=31):
    return np.random.default_rng(seed).integers(0, 4, GENOME_LEN)


def substitute(seq, rng, every, offset=0):
    """A copy of `seq` with a substitution every `every` bases from
    `offset` on."""
    s = seq.copy()
    pos = np.arange(offset, len(s), every)
    s[pos] = (s[pos] + rng.integers(1, 4, len(pos))) % 4
    return s


def write_reads(path, seq, seed, n_reads):
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for i in range(n_reads):
            st = rng.integers(0, len(seq) - READ_LEN)
            r = seq[st:st + READ_LEN].copy()
            m = rng.random(READ_LEN) < 0.01
            r[m] = (r[m] + rng.integers(1, 4, int(m.sum()))) % 4
            if rng.random() < 0.5:
                r = (3 - r)[::-1]
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, ALPH[r].tobytes(),
                                              b"I" * READ_LEN))


def write_fasta(path, seqs, seed=0):
    """Multi-line FASTA (60 a line) of base-code arrays (4 = N), with a
    few lowercase bases."""
    rng = np.random.default_rng(seed)
    alph = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as f:
        for i, s in enumerate(seqs):
            b = alph[s].copy()
            if len(b) > 50:
                j = rng.integers(0, len(b), 4)
                b[j] = np.where(b[j] != ord("N"), b[j] + 32, b[j])
            f.write(b">ctg%d len=%d\n" % (i, len(s)))
            raw = b.tobytes()
            for j in range(0, len(raw), 60):
                f.write(raw[j:j + 60] + b"\n")


def assembly(g, seed, every, offset):
    """The genome as contigs of 4-9 kbp with a substitution every `every`
    bases from `offset`, an N run in every third contig, and one contig
    shorter than k."""
    rng = np.random.default_rng(seed)
    s = substitute(g, rng, every, offset)
    cuts = np.cumsum(rng.integers(4_000, 9_000, 12))
    seqs = [c for c in np.split(s, cuts[cuts < len(s)]) if len(c)]
    for c in seqs[::3]:
        c[rng.integers(0, len(c) - 40):][:30] = 4
    seqs.insert(2, s[100:115].copy())
    return seqs


def write_inputs(d, g=None):
    """Every input file under directory `d`; returns their paths."""
    g = genome() if g is None else g
    rng = np.random.default_rng(5)
    paths = {"reads_a": f"{d}/a.fq", "reads_b": f"{d}/b.fq"}
    write_reads(paths["reads_a"], g, 1, 3_000)
    write_reads(paths["reads_b"], substitute(g, rng, 150, 7), 2, 3_000)
    for i, (every, offset) in enumerate(((2_000, 0), (1_500, 311),
                                         (900, 57), (3_000, 1_001))):
        paths[f"asm{i}"] = f"{d}/asm{i}.fa"
        write_fasta(paths[f"asm{i}"], assembly(g, 10 + i, every, offset),
                    seed=i)
    for name, (a, b) in (("chrY", (0, Y_END)), ("chrX", (Y_END, X_END)),
                         ("PAR", (X_END, PAR_END))):
        paths[name] = f"{d}/{name}.fa"
        write_fasta(paths[name], [g[a:b]], seed=3)
    for hap, region, seed in ((1, (Y_END, X_END), 21), (2, (0, Y_END), 22)):
        r = np.random.default_rng(seed)
        pieces = [g[region[0]:region[1]], g[X_END:PAR_END],
                  g[PAR_END:PAR_END + 17_000], g[PAR_END + 6_000:]]
        seqs = []
        for p in pieces:
            p = substitute(p, r, 700, int(r.integers(0, 700)))
            cut = int(r.integers(len(p) // 3, 2 * len(p) // 3))
            seqs += [p[:cut], p[cut:]]
        seqs.insert(3, g[500:520].copy())
        paths[f"hap{hap}"] = f"{d}/hap{hap}.fa"
        write_fasta(paths[f"hap{hap}"], seqs, seed=hap)
    return paths
