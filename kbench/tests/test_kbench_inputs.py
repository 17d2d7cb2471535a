"""The generator, the pipes and the -b protocol's choice of path."""

import os
import threading

import numpy as np
import pytest
import torch

from kbench import feed, gen, inputs
from yak_tpu_torch.models.count import CountOpts, literal_two_pass

CFG = {"genome_bp": 5000, "read_len": 150, "coverage": 6,
       "read_sub_rate": 0.003, "read_rc_frac": 0.5, "k": 31, "pre": 10,
       "assembly": {"contig_min_bp": 300, "contig_max_bp": 1500,
                    "length_seed": 3, "sub_rate": 0.01, "rc_frac": 0.5}}


def test_generator_is_deterministic_for_a_seed():
    a_reads, a_seqs = inputs.make(CFG, 2 ** 31 + 11, "cpu")
    b_reads, b_seqs = inputs.make(CFG, 2 ** 31 + 11, "cpu")
    c_reads, c_seqs = inputs.make(CFG, 2 ** 31 + 12, "cpu")
    assert torch.equal(a_reads, b_reads)
    assert all(n == m and torch.equal(x, y)
               for (n, x), (m, y) in zip(a_seqs, b_seqs))
    assert not torch.equal(a_reads, c_reads)
    assert np.array_equal(gen.fastq(a_reads), gen.fastq(b_reads))


def test_every_seed_gets_the_same_work():
    """The contig lengths are one fixed set, in another order a seed; the
    reads are as many, of one length."""
    sizes = []
    for seed in (1, 2, 3):
        reads, seqs = inputs.make(CFG, seed, "cpu")
        assert reads.shape == (inputs.n_reads(CFG), 150)
        sizes.append(sorted(c.numel() for _, c in seqs))
        assert sum(sizes[-1]) == CFG["genome_bp"]
    assert sizes[0] == sizes[1] == sizes[2]


def test_fastq_layout():
    codes = torch.tensor([[0, 1, 2, 3], [3, 3, 0, 0]], dtype=torch.uint8)
    text = gen.fastq(codes, name_digits=3).tobytes()
    assert text == b"@r000\nACGT\n+\nIIII\n@r001\nTTAA\n+\nIIII\n"
    assert gen.fasta([codes[0]], ["c"]) == b">c\nACGT\n"


def test_pipes_and_links_choose_the_protocol(tmp_path):
    """Two named pipes (as `<(zcat ...)` gives) or a hard link are two
    paths: the literal two-pass; a symlink resolves to its target and
    the same path twice is one: the same-file shortcut."""
    opt = CountOpts(bf_shift=20, device="cpu")
    a, b = str(tmp_path / "a.fq"), str(tmp_path / "b.fq")
    feed.make_pipe(a)
    feed.make_pipe(b)
    assert literal_two_pass([a, b], opt)
    assert not literal_two_pass([a, a], opt)
    assert not literal_two_pass([a], opt)
    f = tmp_path / "r.fq"
    f.write_text("@r\nACGT\n+\nIIII\n")
    os.link(f, tmp_path / "hard.fq")
    os.symlink(f, tmp_path / "soft.fq")
    assert literal_two_pass([str(f), str(tmp_path / "hard.fq")], opt)
    assert not literal_two_pass([str(f), str(tmp_path / "soft.fq")], opt)


def test_feed_serves_the_whole_text(tmp_path):
    p = feed.make_pipe(str(tmp_path / "p"))
    data = np.arange(3 << 20, dtype=np.uint32).view(np.uint8)
    got = []
    with feed.Feed(p, data):
        with open(p, "rb") as f:
            got.append(f.read())
    assert got[0] == data.tobytes()


def test_feed_ends_when_the_reader_never_comes_or_stops(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(feed, "WAIT_S", 0.5)
    p = feed.make_pipe(str(tmp_path / "p"))
    data = bytes(4 << 20)
    with pytest.raises(RuntimeError, match="read 0 of"):
        with feed.Feed(p, data):
            pass
    with pytest.raises(RuntimeError, match="the program read"):
        with feed.Feed(p, data):
            with open(p, "rb") as f:
                f.read(1000)
    with pytest.raises(KeyError):
        with feed.Feed(p, data):
            raise KeyError("the job failed")
    assert threading.active_count() < 5
