"""The plain reference against a loop written from yak's count.c, and
against the program on the same generated inputs (CPU, tiny sizes)."""

import contextlib
import io
import math

import numpy as np
import pytest
import torch

from kbench import feed, gen, inputs
from kbench.reference import kmers
from kbench.reference import qv as ref_qv
from yak_tpu_torch.models.count import CountOpts, count
from yak_tpu_torch.models.qv import QvOpts, main_qv

K = 31
CFG = {"genome_bp": 6000, "read_len": 150, "coverage": 30,
       "read_sub_rate": 0.003, "read_rc_frac": 0.5, "k": K, "pre": 10}
ASM = {"contig_min_bp": 500, "contig_max_bp": 2500, "length_seed": 7,
       "sub_rate": 0.001, "rc_frac": 0.5}


def loop_hashes(seq, k):
    """count.c's loop, one base at a time, in Python integers."""
    mask, shift = (1 << 2 * k) - 1, 2 * (k - 1)
    x0 = x1 = 0
    out = []
    for i, c in enumerate(seq):
        x0 = (x0 << 2 | c) & mask
        x1 = x1 >> 2 | (3 - c) << shift
        if i >= k - 1:
            y = min(x0, x1)
            y = (~y + (y << 21)) & mask
            y ^= y >> 24
            y = ((y + (y << 3)) + (y << 8)) & mask
            y ^= y >> 14
            y = ((y + (y << 2)) + (y << 4)) & mask
            y ^= y >> 28
            y = (y + (y << 31)) & mask
            out.append(y)
    return out


@pytest.mark.parametrize("k", [1, 17, 31])
def test_window_hashes_match_count_loop(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, (3, 80), dtype=np.uint8)
    got = kmers.window_hashes(torch.from_numpy(codes), k)
    for row, h in zip(codes, got):
        assert h.tolist() == loop_hashes(row.tolist(), k)


def test_window_hashes_refuse_n_and_long_k():
    with pytest.raises(ValueError):
        kmers.window_hashes(torch.full((1, 40), 4, dtype=torch.uint8), 21)
    with pytest.raises(ValueError):
        kmers.window_hashes(torch.zeros((1, 40), dtype=torch.uint8), 33)


def program_table(tmp_path, fastq, bf_shift, two):
    """The program's `count` of the FASTQ text through one pipe, or two
    (the literal -b two-pass)."""
    pipes = [feed.make_pipe(str(tmp_path / f"r{i}.fq"))
             for i in range(2 if two else 1)]
    with feed.Feed(pipes[0], fastq), contextlib.ExitStack() as more:
        for p in pipes[1:]:
            more.enter_context(feed.Feed(p, fastq))
        return count(pipes, CountOpts(k=K, bf_shift=bf_shift,
                                      chunk_size=1 << 15, device="cpu"))


@pytest.mark.parametrize("bf_shift,two", [(0, False), (20, True),
                                          (20, False)])
def test_count_reference_matches_program(tmp_path, bf_shift, two):
    reads, _ = inputs.make(CFG, 99, "cpu")
    table = program_table(tmp_path, gen.fastq(reads), bf_shift, two)
    keys, cnt = table.items()
    rk, rc = kmers.count(inputs.read_blocks(reads, 1000), K)
    if bf_shift:
        rk, rc = kmers.two_pass_table(rk, rc)
    assert np.array_equal(keys.astype(np.int64), rk.numpy())
    assert np.array_equal(cnt, rc.clamp(max=1023).numpy())
    assert np.array_equal(table.hist(), kmers.hist(rc).numpy())


def test_qv_reference_matches_program(tmp_path):
    cfg = dict(CFG, assembly=ASM)
    reads, seqs = inputs.make(cfg, 5, "cpu")
    table = program_table(tmp_path, gen.fastq(reads), 20, False)
    asm = tmp_path / "asm.fa"
    asm.write_bytes(gen.fasta([c for _, c in seqs], [n for n, _ in seqs]))
    rk, rc = kmers.two_pass_table(*kmers.count(inputs.read_blocks(reads),
                                               K))
    for min_len in (0, 1500):
        out = io.StringIO()
        main_qv(QvOpts(print_each=True, min_len=min_len, chunk_size=1 << 14),
                table, str(asm), out=out)
        ref = ref_qv.qv_text(rk, rc, seqs, K, min_len, 0.5, 0.00004)
        assert out.getvalue() == ref
        assert ref.count("\nSQ\t") == sum(c.numel() >= min_len
                                          for _, c in seqs)


def test_qv_solve_degenerate_inputs():
    # no k-mer seen twice: a -nan coverage, as yak prints it
    assert math.isnan(ref_qv.solve([0] * 1024, [5, 3] + [0] * 1022, K,
                                   4e-5)[2])
    text = ref_qv.qv_text(torch.zeros(0, dtype=torch.int64),
                          torch.zeros(0, dtype=torch.int64),
                          [("s", torch.zeros(40, dtype=torch.uint8))],
                          K, 0, 0.5, 4e-5)
    assert "CV\t-nan\n" in text and "SQ\ts\t40\t10\t0\t0.00\n" in text
