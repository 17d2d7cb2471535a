"""A configuration's inputs, made from the run's seed by `gen`: the
genome, the reads and, where the configuration has an assembly, its
contigs.  Made once in set-up for the program (as text on the host)
and once more after the window for the reference (as codes on the
device): the same seed gives the same bases both times."""

from kbench import gen


def n_reads(cfg):
    return cfg["genome_bp"] * cfg["coverage"] // cfg["read_len"]


def make(cfg, seed, device):
    """(reads uint8 [n, read_len], contigs [(name, codes)] or None)."""
    g = gen.generator(seed, device)
    genome = gen.genome(g, cfg["genome_bp"], device)
    reads = gen.reads(g, genome, n_reads(cfg), cfg["read_len"],
                      cfg["read_sub_rate"], cfg["read_rc_frac"])
    asm = cfg.get("assembly")
    if asm is None:
        return reads, None
    lengths = gen.contig_lengths(cfg["genome_bp"], asm["contig_min_bp"],
                                 asm["contig_max_bp"], asm["length_seed"])
    seqs = gen.contigs(g, genome, lengths, asm["sub_rate"], asm["rc_frac"])
    return reads, [(f"ctg{i:06d}", c) for i, c in enumerate(seqs)]


def read_blocks(reads, rows=1 << 19):
    """The reads in blocks of rows, for the reference's bounded peak."""
    return (reads[r:r + rows] for r in range(0, reads.shape[0], rows))
