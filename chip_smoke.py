"""On-card smoke check of the PyTorch/CUDA port (`yak_tpu_torch`).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. the card's name and power limit (nvidia-smi), torch and CUDA
     versions;
  2. build the hand-written kernels (csrc/merge_reduce.cu, which holds
     the merge-reduce and merge-JOIN entry points, csrc/compact.cu,
     csrc/sort.cu and csrc/scan.cu) with one nvcc each, and the host library
     (native/fastx.cpp and native/khlayout.cpp) with g++, side by side,
     into build/yak_tpu_torch/; the host library must load;
  3. kernel vs its plain torch version on the card: the kernel's tile
     must be the fixtures' CUDA_TILE (tests/torch_merge_cases.py and
     tests/torch_join_cases.py), so that their runs sit on its edges;
     the merge cases of tests/torch_merge_cases.py, and the inputs of
     every fold of one
     count of the phase 4 workload (captured as the count path passes
     them to the wrapper, so at its exact shapes; this count is also
     phase 4's warm-up); keys, counts, size, n_new and the overflow flag
     must be equal, and both are timed with CUDA events on each fold;
  4. the count path at real size: bench.py's count workload (seed 42,
     2 Mbp genome, 400,000 x 150 bp reads, 0.3% errors) counted by
     KmerTable(31, cap_log2=23, flush_lanes=4*4194281, device="cuda");
     the distinct total and the histogram digest must equal the JAX
     package's gates (6226713, 669014fae5d3), and the kernel must have
     launched; prints the rate and a per-fold split on the device
     timeline (CUDA events) and on the host clock; then the same count
     from a 2^21-lane table must grow (overflow replay) and pass the
     same gates;
  5. the CLI on the card and on the CPU must dump byte-identical .yak
     files for a FASTQ and a FASTA with N runs;
  6. the lookup kernels (the merge-JOIN entry point of merge_reduce.cu
     and csrc/compact.cu) vs their plain torch versions on the card: the
     compaction's tile must be tests/torch_compact_cases.py's CUDA_TILE;
     the cases of tests/torch_join_cases.py and
     tests/torch_compact_cases.py (the compaction's at each 4-byte
     offset from a 16-byte boundary, and with klo the same tensor as
     khi), and the arguments of every JOIN and compaction call of one qv
     run (bench.py's warm-up read set) and one chkerr run of each phase
     8 input (captured as the lookup path passes them, so at its exact
     shapes; these runs are also the warm-up); outputs must be equal,
     and both versions are timed with CUDA events at the main path's
     shapes (JOIN: cap 2^23, 6,226,713 live keys, 8,388,578 queries;
     compaction: 8,388,578 lanes), the compaction also on a dense
     synthetic input (8,388,578 lanes, half kept, seed 16);
  7. qv at real size: bench.py's qv workload (400,000 error-free 150 bp
     reads of the phase 4 genome, seeds 101 and 102, chunk 2^23) through
     models.qv.run_qv against phase 4's table; cnt must sum to
     48,000,000 with cnt[0] == 0 and md5 digests 70a2f8de2e2c and
     72893d32c67e (bench.py:249-251), and the JOIN kernel must have
     launched; prints lookups/s and a per-chunk split (extract, sort,
     join, post) on the device timeline and on the host clock;
  8. chkerr at real size: models.chkerr.main_chkerr against the same
     table for the phase 4 genome cut into 20 contigs of 100,000 bp with
     a substitution every 2 kbp and a 40 kbp novel stretch across the
     2^20 chunk edge (chunk 2^20; its low run must come out as one row)
     and for the 400,000 error-bearing phase 4 reads as FASTQ (chunk
     2^23); the compaction kernel must have launched; prints rows and
     the output's md5; then the contigs again at a marker budget of 64,
     past which every chunk copies all its markers from the device,
     must print the same;
  9. the CLI's qv -p and chkerr -c 12 on the card and on the CPU (called in
     this process, chunk 16384 so sequences span chunks) must print
     byte-identical stdout for phase 5's FASTQ and FASTA, against a
     table counted from the FASTQ;
 10. the -b Bloom two-pass at real size: bench.py's bloom workload (phase
     4's 400,000 reads as single-line FASTA, chunk 2^23, cap 2^23) through
     models.count.count as the literal two-pass over two paths (hard
     links) to that file, at -b24 (the sentinel gate post through the
     compaction kernel, the weighted merge in pass 1, the count-mode
     merge in pass 2) and at -b37 (a 16 GiB filter, the sparse gate
     post updating it in place), then the same-file shortcut; each must
     give 2,044,839 distinct k-mers and histogram digest c94d8a6166ad
     (bench.py:514-515) and launch its kernels; prints walls, bench.py's
     96,000,000 extraction units over the wall, and a per-fold split on
     the device timeline (gate post, merge) with the device idle share;
 11. the k=33 count at real size: phase 4's chunks through
     KmerTable(33, cap_log2=23, flush_lanes=4*4194281), the wide merge
     in every fold; gates 6,412,500 and a56a84001d46 (bench.py:565-566);
 12. the overflow replays: the -b24 literal two-pass and the k=33 count
     again from a 2^21-lane table, which must grow and pass the same
     gates (the -b24 replay through the gated fold's kept filter);
 13. the weighted and wide modes of the merge kernel vs the plain torch
     version on the card: the mode cases of tests/torch_merge_cases.py
     and every merge call captured from phases 10-12 (count-mode calls
     of pass 2 included), and every compaction call of the sentinel gate
     post; timed at the main path's shapes;
 14. the CLI's count -b24 (two files) and count -k33 in this process on
     the card and on the CPU must dump byte-identical .yak files; phases
     1-14 must not have launched the sort kernel;
 15. the sort kernel (csrc/sort.cu, the psort engine's batch sort, a
     radix sort) vs its plain torch version on the card, bit for bit:
     every case of tests/torch_sort_cases.py, and every sort call of a
     warm-up run of phase 16's workloads (captured as the psort engine
     passes them, so at its exact shapes); the input planes must be
     unchanged after each call, and the number of passes the kernel's
     plan ran must equal the plain plan's (ops/sort.plan_plain); each
     instantiation (int64 or int32 keys, with or without an int32
     payload) timed at its largest captured call, beside torch.sort on
     the same keys (the default engine's call), with its pass count;
 16. the psort engine at real size, with YAK_TPU_PSORT=1 set in this
     process and unset after: phase 4's count (6,226,713 /
     669014fae5d3), phase 11's k=33 count (6,412,500 / a56a84001d46),
     phase 10's -b24 literal two-pass (2,044,839 / c94d8a6166ad, the
     plain gate post: no compaction launch), qv seed 101 against the
     psort count's table (48,000,000, cnt[0] 0, 70a2f8de2e2c), chkerr on
     phase 8's contigs and reads (the same rows, no compaction launch),
     each launching the sort kernel, with per-fold and per-chunk splits;
     then the CLI's count -k31 on the card and on the CPU under the
     variable must dump byte-identical .yak files;
 17. the trio lookup kernels vs their plain torch versions on the card,
     bit for bit: every JOIN and compaction call of a triobin -p run
     (the first 4 contigs of phase 18's warm-up set: one full chunk)
     and of a trioeval run (phase 20's warm-up set), and every sort call
     of the same two runs under the psort engine; the JOIN, the two
     compactions (triobin -p's markers, trioeval's) and the three sorts
     (the query sort, trioeval's markers, triobin -p's markers) timed at
     those calls;
 18. triobin at real size: bench.py's flag table, phase 4's keys with
     flag (h >> 7) % 15 + 1 (bench.py:297-300), against 24 contigs of
     the genome rotated at random offsets (bench.py:305-309), seed 6 as
     the warm-up, then seeds 7 and 8, whose stdout md5[:12] must equal
     TB_DIGEST (bench.py:252); prints positions/s (24 x (2,000,000 -
     30) a seed), the per-chunk split on the device timeline (extract,
     sort, join, post, markers) and the device's idle share;
 19. triobin -p on seed 7, on both engines: the output less its D rows
     must be phase 18's, the psort engine's bytes the default engine's;
     the D rows pass the marker budget, so chunks copy every marker
     from the device;
 20. trioeval at real size: the flags of the port's own extraction of
     the genome, 2 and 8 in alternating 10 kb blocks, the first
     occurrence of a hash kept (bench.py:466-476), seeds 17 and 18 after
     phase 17's run of seed 16; md5[:12] must equal TE_DIGEST
     (bench.py:450);
 21. restore-into at real size: phase 4's table dumped as pat and the
     -b24 table (phase 10's, by the same-file shortcut) as mat;
     load_trio_tables on the card and on the CPU must give the same
     keys and flags;
 22. the psort engine on the trio paths: triobin seed 7 and trioeval
     seed 17 under YAK_TPU_PSORT=1, the same digests, the sort kernel
     launched and the compaction not;
 23. the CLI's triobin -p and trioeval -e (pat counted from phase 5's
     FASTQ, mat from its FASTA, the FASTA as the child) and qv -p and
     chkerr -c 12 against a table counted with -k33, chunk 16384, on the
     card and on the CPU in this process: byte-identical stdout;
 24. the table algebra and print at real size: phase 4's table (a.yak)
     and the -b24 table (phase 4's counts >= 2, bench.py's bloom gates;
     b24.yak) restored on the card; subtract and isec of the first by
     the second (one JOIN of its 2^23 lanes with the identity as their
     lanes; 4,181,874 and 2,044,839 keys and the dumps' md5s); recount
     of a.yak over the reads phase 4 counted as one-line FASTA (phase
     4's gates) and of phase 11's k=33 table likewise (phase 11's
     gates), increment-only folds; cntasm -c1 -x1 through the CLI of
     three assemblies of the genome (20 x 100 kbp; no substitution, one
     every 2 kbp, one every 1.5 kbp at other offsets; the dump's md5);
     print -c of a.yak through the CLI (6,226,713 lines, md5); the JOIN
     and count-mode calls held against their plain versions, and timed
     at subtract's JOIN, a recount fold and a presence vote;
 25. inspect of a.yak alone (host) and against b24.yak on the card, in
     two 2^22-key batches (stdout md5s), the JOIN calls checked;
 26. sexchr at real size: chrY, chrX and PAR tables counted at k=31
     from the genome's [0, 300 kb), [300 kb, 1.3 Mb) and [1.3, 1.4 Mb),
     loaded with the SEXCHR1/2/3 modes; hap1 and hap2 the rotation sets
     of trio seeds 7 and 8 cut into 100 kbp contigs (six 2^23-base
     chunks each); the md5 of its stdout and of groupxy's lines on it;
 27. recount (both tables), two-table inspect and sexchr under
     YAK_TPU_PSORT=1: the same gates, the sort kernel launched;
 28. recount, cntasm, subtract, isec, print -c, inspect (one and two
     tables), sexchr and groupxy through the CLI on the card and on the
     CPU in this process, chunk 16384, on phase 5's inputs: byte-identical
     stdout and dumps;
 29. count on a mesh of four shards of the card (parallel/mesh.py, a
     mesh of [cuda:0] * 4): phase 10's one-line FASTA of phase 4's reads
     through count_file_mesh at chunk 2^23 (two groups of four chunks,
     each chunk extracted on its shard, each hash routed to its owner
     shard, each shard's batch folded by its own table), 2^21 lanes a
     shard, at k=31 and k=33, on the default engine and under psort:
     phase 4's and phase 11's gates; the default engine's dumps md5-equal
     to the one-device dumps (phase 4's table, and phase 11's count
     again), the psort engine's items equal to them shard by shard; the
     psort k=31 run starts from 2^19 lanes a shard, so every shard's
     first fold overflows and replays one fold late on the card; every
     captured per-shard merge-reduce call, and under psort every sort
     call, held against its plain version bit for bit; per group the
     device and host spans (the routing's included) beside phase 4's
     one-device wall and busy time;
 30. qv on the same mesh: seeds 101 and 102 against phase 29's k=31 table
     on both engines through the routed lookup (each owner shard sorts
     and JOINs its queries, the values go home by slot); phase 7's gates;
     every captured per-shard JOIN and sort call held against its plain
     version; per group the spans beside phase 7's one-device figures;
 31. the native reader at real size: phase 4's reads as FASTQ, gzip
     FASTQ and phase 10's one-line FASTA, each counted by
     models.count.count (chunk 2^23) through the native reader
     (native/fastx.cpp, built in phase 2 by g++ beside the nvcc builds;
     ChunkSource must have taken it): phase 4's gates, every merge call
     held against its plain version; the FASTA and the FASTQ again
     through the Python reader; for each, the wall, the host seconds
     inside the reader and the device's busy and idle shares, reader
     beside reader; then qv seed 101 through the native reader against
     the native FASTA count's table (phase 7's gates);
 32. -X at real size: `count -X -k31` of the reads, `count -X -k31 -b24`
     with pass 1 the reads and pass 2 the seed-101 qv reads (two
     different files: the serial-exact Bloom gate in pass 1), and `count
     -X -k33`, through the CLI in this process: each dump passes its
     cross-check against the table and its md5 must be EXACT_DIGEST's;
     every captured count, weighted and wide merge call is held against
     its plain version; `count -X -b37` must exit 1 (the packed rank key
     would not fit, as yak_tpu refuses it) and `-X -b24` under
     YAK_TPU_PSORT=1 must raise;
 33. -b on a mesh of four shards of the card: phase 10's -b24 literal
     two-pass over the hard link through parallel.mesh.count_mesh (chunk
     2^23, 2^21 lanes a shard; each shard gates a group's routed batch
     by its 2^22-bit slice of the filter through the sentinel post and
     folds it by the weighted merge, pass 2 in count mode), with
     bench.py's bloom gates and its dump md5-equal to the one-device
     dump; then `count -X -k31 -b24` of the reads and the seed-101 reads
     through the CLI under YAK_TPU_MESH=1 (both passes on the mesh, the
     serial ranks routed with the hashes), md5-gated by
     EXACT_DIGEST["b24"]; every captured weighted and count-mode merge
     and compaction call held against its plain version, the per-group
     device and host spans printed;
 34. chkerr, triobin, trioeval and sexchr on the same mesh, their tables
     dealt onto it: chkerr of phase 8's contigs and reads (phase 8's
     output, and the contigs again at a marker budget of 64), triobin of
     seeds 7 and 8 (TB_DIGEST), trioeval of seeds 17 and 18 (TE_DIGEST)
     and sexchr of phase 26's inputs (ALGEBRA_DIGEST), each chunk's post
     on its shard's device; every captured JOIN and compaction call held
     against its plain version;
 35. a count over two processes, two shards of the card each
     (parallel/multihost.py): two copies of this script in worker mode
     (`--multihost-worker`), joined over gloo at a free loopback port,
     each driving [cuda:0] * 2 of a global mesh of four shards; each
     counts phase 10's FASTA at chunk 2^23 (after a warm-up count) at
     k=31, the -b24 literal two-pass over the hard link and k=31 under
     psort through count_file_multihost, with phase 4's and phase 10's
     gates, its dump md5-equal to the one-device dump, every captured
     merge, compaction and sort call held against its plain version;
     it logs its walls, the device and host spans per group and the
     exchange's host time per group.  A worker that fails or runs past
     MH_TIMEOUT_S fails the phase, the other killed;
 36. the other engines and knobs at real size, each variable set in
     this process for its runs and unset after, with the launch counts
     set to 0 just before each run and read just after: phase 4's count
     under YAK_TPU_ENGINE=compact (the merged stream closed up by the
     compaction kernel) and =xla (the sort-merge in plain torch, no
     kernel), compact again from 2^21 lanes (the replay), phase 11's
     k=33 under YAK_TPU_WIDE=0, phase 10's -b24 literal under
     ENGINE=compact, =xla and YAK_TPU_BLOOM_SENTINEL=0, each with its
     gates; `count -X -k31 -b24` (phase 32's) under ENGINE=compact
     (EXACT_DIGEST); qv seeds 101 and 102 under YAK_TPU_JOIN=0 (the
     sorted join) and YAK_TPU_QV_SEG=1 (the seg-payload JOIN post);
     chkerr of the reads under YAK_TPU_MARK_COMPACT=0 and JOIN=0 (phase
     8's text); triobin seed 7 under JOIN=0 (TB_DIGEST), trioeval seed
     17 under MARK_COMPACT=0 (TE_DIGEST); subtract, isec, inspect and
     sexchr under JOIN=0 (ALGEBRA_DIGEST); count k31 and qv 101 under
     YAK_TPU_PALLAS=0, which must launch no kernel.  Every compaction
     call of the compact engine and every JOIN call of QV_SEG is held
     bit for bit against its plain version, and one of each is timed;
     each run logs its device ms per fold or chunk (CUDA events) and
     its wall beside the default engine's of the same run;
 37. the last-set-lane kernel (csrc/scan.cu) vs torch.cummax
     (scan.last_set_lane_plain) on the card: phase 10's -b37 literal
     two-pass again (its gates), every call of its default gate posts
     (`_runs`' run heads over a fold's B lanes, `bloom_insert`'s sparse
     tail's word-run heads over its n_hashes x B probe lanes) held bit
     for bit against cummax, one launch a call; then masks of the
     benchmark's -b37 count's sizes (a fold's B = 16,777,156 lanes and
     its 67,108,624 probe lanes, at the densities its folds give:
     0.6135 and 0.5662) checked and timed.

Every path that reads a sequence file takes the native reader, as
`yak_tpu` does; phases 3, 4 and 11 fold chunks packed by this script.

The md5 gates of phases 24-26 (ALGEBRA_DIGEST) are what `yak_tpu`
prints on the CPU for the same seeded inputs (tools/algebra_gates.py),
and those of phase 32 (EXACT_DIGEST) likewise (tools/exact_gates.py).

The last two lines of stdout are a JSON line of per-kernel results
(`launches` summed over the paths that drive the kernel, each with the
counts set to 0 just before it and read just after, and by path under
`launches_by_path`; `ms` and `plain_ms` back to back, `device_ms` and
`plain_device_ms` device only, see time_ms; `bound_ms` the bytes the
call must move over the H100's 3.35 TB/s; `library_ms` one PyTorch call
computing the same function, where there is one; the sort's entries,
one per instantiation, name the other four TPU kernels it replaces
under `replaces_also` and give the radix passes of the timed call
under `passes`; the JOIN's gives under `identity_qidx_device_ms` its
device time on the same call with qidx the identity, whose stores
coalesce; the compaction's top-level times are chkerr's call, and
`shapes` gives the times, bound and library time of each timed shape:
chkerr, the -b24 sentinel post (phase 13), the dense input, the
trio paths' calls (phase 17: `triobin_diff`, `trioeval`) and the
compact engine's third fold (phase 36: `compact_engine_fold`, whose
bound reads every lane of the three planes); the JOIN's
and the sorts' `shapes` give their trio calls likewise, the JOIN's also
subtract's call (phase 24) and QV_SEG's (phase 36: `qv_seg`, the
identity as its store lanes), and the count mode's a recount fold and a
cntasm presence vote; the `*_mesh` entries are the per-shard launches
of phases 29-30, which replace yak_tpu's shard_mapped wrappers
(`merge_reduce_presorted_mesh`, `sort_planes_mesh` with its pass chain,
and `sort_planes32_mesh`, whose order restores are the JOIN's stores and
the scatter by slot), timed at a shard's call, and of phases 33-34,
whose weighted merges and compactions have their own entries
(`merge_reduce_weighted_mesh`, `compact_mesh`), in place of yak_tpu's
shard_mapped count step with its bloom_cfg and lookup steps; phase
35's workers' launches, summed, are their `multihost` path; the
last-set-lane kernel's entry (phase 37) times the sparse tail's mask at
the top level and both masks under `shapes`, with `plain_ms` the
library-only version that the plain paths take on the card
(sorttable.last_set_lane, a scatter) and `library_ms` torch.cummax) and
the contract line
{"ok": true, "device": {...}}.  Imports no JAX.
"""

import atexit
import contextlib
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()        # after the imports; phase() reads it
TOTAL_GATE = 6226713                 # bench.py:673
HIST_GATE = "669014fae5d3"           # bench.py:248
K = 31
READ_LEN = 150
N_READS = 400_000
GENOME_LEN = 2_000_000
ERR = 0.003
CHUNK_READS = 27_776                 # chunk = CHUNK_READS * 151 bases
SORT_INSTANCES = ("i64", "i64_i32", "i32", "i32_i32")   # ops/sort.INSTANCES
KERNELS = {
    "merge_reduce": {"name": "merge_reduce", "route": "cuda",
                     "source": "yak_tpu_torch/csrc/merge_reduce.cu",
                     "replaces": "yak_tpu/ops/pallas_merge.py:155"},
    "merge_reduce_weighted": {"name": "merge_reduce_weighted",
                              "route": "cuda",
                              "source": "yak_tpu_torch/csrc/merge_reduce.cu",
                              "replaces": "yak_tpu/ops/pallas_merge.py:155"},
    "merge_reduce_wide": {"name": "merge_reduce_wide", "route": "cuda",
                          "source": "yak_tpu_torch/csrc/merge_reduce.cu",
                          "replaces": "yak_tpu/ops/pallas_merge.py:155"},
    "merge_join": {"name": "merge_join", "route": "cuda",
                   "source": "yak_tpu_torch/csrc/merge_reduce.cu",
                   "replaces": "yak_tpu/ops/pallas_merge.py:241"},
    "compact": {"name": "compact", "route": "cuda",
                "source": "yak_tpu_torch/csrc/compact.cu",
                "replaces": "yak_tpu/ops/pallas_compact.py:124"},
    **{f"sort_{inst}": {
        "name": f"sort_{inst}", "route": "cuda",
        "source": "yak_tpu_torch/csrc/sort.cu",
        "replaces": "yak_tpu/ops/pallas_sort.py:250",
        "replaces_also": [f"yak_tpu/ops/pallas_sort.py:{line}"
                          for line in (167, 204, 107, 134)]}
       for inst in SORT_INSTANCES},
    "last_set_lane": {"name": "last_set_lane", "route": "cuda",
                      "source": "yak_tpu_torch/csrc/scan.cu",
                      "replaces": "jax.lax.cummax (XLA, no TPU kernel): "
                                  "yak_tpu/ops/countstep.py:464, "
                                  "yak_tpu/ops/bloom.py:314"},
}
QV_SEEDS = {101: "70a2f8de2e2c", 102: "72893d32c67e"}   # bench.py:250
QV_SUM = 48_000_000                                    # bench.py:251
N_CONTIGS, CONTIG_LEN = 20, 100_000
SUB_EVERY = 2_000          # one substitution per 2 kbp of each contig
NOVEL = (10, 30_000, 70_000)   # contig, novel stretch [30 kbp, 70 kbp)
BLOOM_DISTINCT = 2_044_839           # bench.py:514
BLOOM_HIST = "c94d8a6166ad"          # bench.py:515
K33 = 33
K33_DISTINCT = 6_412_500             # bench.py:565
K33_HIST = "a56a84001d46"            # bench.py:566
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory rate
REPLAY_CAP_LOG2 = 21                 # phase 12's first table capacity
DENSE_COMPACT = (8_388_578, 0.5, 16)  # phase 6's dense compaction input
TRIO_CONTIGS = 24                    # bench.py:302
TB_DIGEST = {7: "d813150efc7a", 8: "34ffd15f941e"}   # bench.py:252
TE_DIGEST = {17: "f3a76225e75b", 18: "d46fdf6d1eea"}  # bench.py:450
MESH_SHARDS = 4                      # phases 29-30: [cuda:0] * 4
MESH_CAP_LOG2 = 21                   # phase 29's lanes a shard (2^23 / 4)
MESH_REPLAY_CAP_LOG2 = 19            # phase 29's replay run
MESH_CHUNK = 1 << 23                 # phase 29's chunk (phase 10's)
ONE_DEVICE = {}      # (wall s, device busy ms) of phases 4, 7, 10, 11, 29
# the engine and lookup knobs phase 36 sets (psort: phases 16, 22, 27)
KNOB_VARS = ("YAK_TPU_PSORT", "YAK_TPU_ENGINE", "YAK_TPU_WIDE",
             "YAK_TPU_JOIN", "YAK_TPU_MARK_COMPACT", "YAK_TPU_BLOOM_SENTINEL",
             "YAK_TPU_QV_SEG", "YAK_TPU_PALLAS")
ONE_DUMP_MD5 = {}    # the one-device k31 and -b24 dumps' md5s, for 35
EXACT_WALLS = {}     # phase 32's (wall s, dump s) a config, for 36


def kept_dir(name):
    """A temporary directory that lives until the script exits (its
    inputs serve a later phase too)."""
    d = tempfile.mkdtemp(prefix=f"yak_tpu_torch_{name}_")
    atexit.register(shutil.rmtree, d, True)
    return d


def log(msg):
    print(msg, flush=True)


def phase(name):
    """Logs a phase's heading with the seconds since T_START, so that a
    phase's time is the difference of two headings."""
    torch.cuda.synchronize()
    log(f"== {name} (at {time.perf_counter() - T_START:.1f} s)")


# -- phase 1 ------------------------------------------------------------

def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


# -- phase 3 ------------------------------------------------------------

def time_ms(fn, reps):
    """(back-to-back ms, device ms) per call of `fn`, from CUDA events
    around `reps` calls after one warm-up call.  The back-to-back figure
    (the kernels line's `ms` and `plain_ms`) times the calls on an idle
    stream, where the host's launch overhead shows whenever it exceeds
    the device time.  The device figure (`device_ms`, `plain_device_ms`)
    is taken with the stream held busy while the calls are queued, so
    the events bracket the device work alone; the spin kernel that holds
    it is torch.cuda._sleep, a private helper of PyTorch's own tests."""
    fn()
    out = []
    for prefill in (False, True):
        torch.cuda.synchronize()
        if prefill:
            torch.cuda._sleep(200_000_000)    # ~0.1 s at the H100's clocks
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        out.append(t0.elapsed_time(t1) / reps)
    return tuple(out)


def compare(merge, args, create, label, weights=None, wide=False):
    """Kernel vs plain on one input; returns the max abs difference
    (0 when equal) after asserting equality."""
    tkeys, tcnt, size, bkeys = args
    ok, oc, ns, nn = merge.merge_reduce(tkeys, tcnt, size, bkeys, create,
                                        weights=weights, wide=wide)
    pk, pc, ps, pn = merge.merge_reduce_plain(tkeys, tcnt, size, bkeys,
                                              create, weights)
    torch.cuda.synchronize()
    cap = tkeys.numel()
    live = min(int(ps), cap)
    err = max(int((ok[:live] - pk[:live]).abs().max()) if live else 0,
              int((oc[:live] - pc[:live]).abs().max()) if live else 0,
              abs(int(ns) - int(ps)), abs(int(nn) - int(pn)))
    if (err or (int(ns) > cap) != (int(ps) > cap)):
        raise AssertionError(
            f"{label}: kernel != plain (size {int(ns)} vs {int(ps)}, "
            f"n_new {int(nn)} vs {int(pn)}, max abs err {err})")
    log(f"  {label}: equal (size {int(ns)}, n_new {int(nn)}, "
        f"overflow {int(ns) > cap})")
    return err


class _Spy:
    """Stands in for a kernel module (ops.merge, ops.compact) inside
    ops.countstep: records the arguments of each call of one of its
    wrappers and forwards every call to the real module."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __getattr__(self, attr):
        fn = getattr(self.module, attr)
        if attr != self.name:
            return fn

        def spy(*args, **kw):
            self.calls.append((args, kw))
            return fn(*args, **kw)
        return spy


@contextlib.contextmanager
def captured(module_attr, name, within="yak_tpu_torch.ops.countstep"):
    """Inside the block, the calls of <module_attr>.<name> made by the
    module `within` (ops.countstep unless named) are recorded; yields
    the list of their (args, kwargs).  The wrappers never write into
    their inputs, so the arguments stay valid after the calls."""
    import importlib

    user = importlib.import_module(within)
    module = getattr(user, module_attr)
    spy = _Spy(module, name)
    setattr(user, module_attr, spy)
    try:
        yield spy.calls
    finally:
        setattr(user, module_attr, module)


def fold_inputs(chunks, dev):
    """The merge-reduce arguments of every fold of one count of `chunks`
    (tkeys, tcnt, size, bkeys, create)."""
    with captured("merge", "merge_reduce") as calls:
        run_count(chunks, dev)
    return [args for args, _kw in calls]


def kernel_checks(dev, chunks):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_join_cases
    from torch_merge_cases import CASES, CUDA_TILE, expected, sorted_table
    from yak_tpu_torch.ops import merge
    from yak_tpu_torch.ops.countstep import sort_batch
    from yak_tpu_torch.ops.keys import torch_to_u64, u64_to_torch

    tile = merge._library().yak_merge_reduce_tile()
    if not tile == CUDA_TILE == torch_join_cases.CUDA_TILE:
        raise AssertionError(f"the kernel's tile is {tile} merged lanes, the "
                             f"fixtures' CUDA_TILE {CUDA_TILE} / "
                             f"{torch_join_cases.CUDA_TILE}")
    log(f"  kernel tile {tile} merged lanes = the fixtures' CUDA_TILE")
    err = 0
    for name, (build, _pallas) in CASES.items():
        hs, cs, batch, valid, cap, create = build()
        tk, tc = sorted_table(hs, cs, cap)
        tkeys = u64_to_torch(tk, dev)
        tcnt = torch.from_numpy(tc).to(dev)
        size = torch.tensor(len(hs), dtype=torch.int32, device=dev)
        bkeys = sort_batch(u64_to_torch(batch, dev),
                           torch.from_numpy(valid).to(dev))
        err = max(err, compare(merge, (tkeys, tcnt, size, bkeys), create,
                               name))
        # and against the contract in plain numpy
        ok, oc, ns, nn = merge.merge_reduce(tkeys, tcnt, size, bkeys,
                                            create)
        wk, wc, wsize, wnew = expected(hs, cs, batch, valid, cap, create)
        got_k = torch_to_u64(ok)[:len(wk)]
        got_c = oc.cpu().numpy()[:len(wc)]
        if not (int(ns) == wsize and int(nn) == wnew
                and np.array_equal(got_k, wk) and np.array_equal(got_c, wc)):
            raise AssertionError(f"{name}: kernel != numpy contract")

    folds = fold_inputs(chunks, dev)
    if not folds:
        raise AssertionError("the count path made no merge-reduce call")
    times = [time_merge(merge, args, {}, f"count fold {i}")
             for i, args in enumerate(folds)]
    for i, args in enumerate(folds):
        err = max(err, compare(merge, args[:4], args[4],
                               f"count fold {i}"))
    # the increment-only mode on the last fold's real inputs
    err = max(err, compare(merge, folds[-1][:4], False,
                           f"count fold {len(folds) - 1}, create=False"))
    return mean_times(times, err, f"the {len(folds)} count folds")


def merge_bound_ms(args, kw, new_size):
    """The least time of one merge-reduce call on the H100: the bytes it
    must move (the live table's keys and counts read, the valid batch
    keys and weights read, the surviving keys and counts written) over
    the device memory rate.  Its arithmetic is a few compares a lane."""
    from yak_tpu_torch.ops.keys import INT64_MAX

    tkeys, _tcnt, size, bkeys = args[:4]
    nb = int((bkeys != INT64_MAX).sum())
    per_lane = 12 if kw.get("weights") is not None else 8
    moved = (12 * min(int(size), tkeys.numel()) + per_lane * nb
             + 12 * min(new_size, tkeys.numel()))
    return moved / HBM_BYTES_PER_S * 1e3


def time_merge(merge, args, kw, label):
    """Times one captured merge-reduce call, kernel and plain version:
    (ms, device_ms, plain_ms, plain_device_ms, bound_ms)."""
    tkeys, tcnt, size, bkeys, create = args
    weights = kw.get("weights")
    ms = time_ms(lambda: merge.merge_reduce(*args, **kw), 20)
    plain_ms = time_ms(lambda: merge.merge_reduce_plain(*args, weights), 5)
    new_size = int(merge.merge_reduce_plain(*args, weights)[2])
    bound = merge_bound_ms(args, kw, new_size)
    log(f"  {label} (cap {tkeys.numel()}, live {int(size)}, B "
        f"{bkeys.numel()}, create {bool(create)}, weights "
        f"{weights is not None}, wide {bool(kw.get('wide'))}): kernel "
        f"{ms[0]:.4f} ms, plain torch {plain_ms[0]:.4f} ms back to back "
        f"(device only: {ms[1]:.4f} / {plain_ms[1]:.4f} ms); bound "
        f"{bound:.4f} ms")
    return ms + plain_ms + (bound,)


def mean_times(times, err, what):
    """A kernels-line entry from several time_merge results."""
    ms, device_ms, plain_ms, plain_device_ms, bound = (
        sum(t[i] for t in times) / len(times) for i in range(5))
    log(f"  mean over {what}: kernel {ms:.4f} ms, plain torch "
        f"{plain_ms:.4f} ms back to back (device only: {device_ms:.4f} / "
        f"{plain_device_ms:.4f} ms), bound {bound:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "device_ms": device_ms, "plain_device_ms": plain_device_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


# -- phase 4 ------------------------------------------------------------

def make_reads():
    """bench.py:71-82, regenerated here."""
    rng = np.random.default_rng(42)
    genome = rng.integers(0, 4, GENOME_LEN, dtype=np.uint8)
    starts = rng.integers(0, GENOME_LEN - READ_LEN + 1, N_READS)
    reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    m = rng.random(reads.shape) < ERR
    reads = np.where(m, (reads + rng.integers(1, 4, reads.shape)) % 4,
                     reads).astype(np.uint8)
    rc = rng.random(N_READS) < 0.5
    reads = np.where(rc[:, None], (3 - reads)[:, ::-1], reads)
    return reads


def pack_chunks(reads):
    """bench.py:85-98: one separator column, flat chunks aligned on read
    boundaries."""
    n = len(reads)
    flat = np.concatenate(
        [reads, np.full((n, 1), 4, np.uint8)], axis=1).reshape(-1)
    per = CHUNK_READS * (READ_LEN + 1)
    chunks = []
    for off in range(0, len(flat), per):
        c = flat[off:off + per]
        if len(c) < per:
            c = np.concatenate([c, np.full(per - len(c), 4, np.uint8)])
        chunks.append(c)
    return chunks


def run_count(chunks, dev, marks=None, cap_log2=23, k=K):
    """Count `chunks` into a new k-mer table on `dev`.  With `marks` (a list),
    appends (name, CUDA event or None, host perf_counter) at each chunk's
    insert ("insert"), at each fold phase as it is queued (the table's
    phase names), before the final flush ("flush") and after the last
    synchronize ("end")."""
    from yak_tpu_torch.table import KmerTable

    table = KmerTable(k, cap_log2=cap_log2, flush_lanes=4 * 4194281,
                      cap_hinted=True, device=dev)

    def host_mark(name):
        if marks is not None:
            marks.append((name, None, time.perf_counter()))

    def hook(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev, time.perf_counter()))

    if marks is not None:
        table.phase_hook = hook
    for c in chunks:
        host_mark("insert")
        table.insert_codes(c)
    host_mark("flush")
    table.flush()
    torch.cuda.synchronize()
    host_mark("end")
    return table


def split_marks(marks, card):
    """Print the per-fold split of one marked count: device spans from
    CUDA events, host spans from perf_counter, and the host time of the
    chunk packing (each "insert" up to the next mark); returns (wall s,
    device busy ms)."""
    pack_s = sum(b[2] - a[2] for a, b in zip(marks, marks[1:])
                 if a[0] == "insert")
    folds, cur = [], None
    for m in marks:
        if m[0] == "start":
            cur = [m]
            folds.append(cur)
        elif cur is not None and m[1] is not None:
            cur.append(m)
    busy_ms = 0.0
    for i, f in enumerate(folds):
        dev_spans = [(b[0], a[1].elapsed_time(b[1])) for a, b in zip(f, f[1:])]
        host_spans = [(b[0], (b[2] - a[2]) * 1e3) for a, b in zip(f, f[1:])]
        busy_ms += sum(ms for name, ms in dev_spans if name != "h2d")
        log(f"  fold {i} device: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in dev_spans) + f" [{card}]")
        log(f"  fold {i} host:   " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in host_spans))
    wall_s = marks[-1][2] - marks[0][2]
    log(f"  host chunk packing (detect_periodic + pack_planes2) inside the "
        f"count: {pack_s:.4f} s of {wall_s:.4f} s wall")
    log(f"  device compute (extract+sort+merge+finalize) {busy_ms:.4f} ms "
        f"of {wall_s * 1e3:.4f} ms wall [{card}]")
    return wall_s, busy_ms


def count_path(dev, card, chunks):
    from yak_tpu_torch.ops import merge

    n_kmers = N_READS * (READ_LEN - K + 1)
    log(f"  {len(chunks)} chunks of {chunks[0].shape[0]} bases, "
        f"{n_kmers} k-mer instances (warmed up by phase 3's count)")

    marks = []
    merge.merge_reduce.launches = 0
    t0 = time.perf_counter()
    table = run_count(chunks, dev, marks)
    wall = time.perf_counter() - t0
    launches = merge.merge_reduce.launches

    check_gates(table, f"kernel launches {launches}")
    if launches <= 0:
        raise AssertionError("the count path never launched the kernel")
    log(f"  count wall {wall:.4f} s, {n_kmers / wall:.1f} k-mers/s "
        f"[{card}]")
    ONE_DEVICE["count"] = split_marks(marks, card)

    # the same host work alone, after the count
    from yak_tpu_torch.io.pack import detect_periodic, pack_planes2

    t0 = time.perf_counter()
    for c in chunks:
        detect_periodic(c)
        pack_planes2(c)
    log(f"  host detect_periodic + pack_planes2 alone: "
        f"{time.perf_counter() - t0:.4f} s for {len(chunks)} chunks")

    # table growth on the card: from 2^21 lanes the folds overflow, are
    # caught one fold late and replay at 2^22, then 2^23
    t0 = time.perf_counter()
    grown = run_count(chunks, dev, cap_log2=21)
    secs = time.perf_counter() - t0
    check_gates(grown, f"grown from cap 2^21 to {grown.cap} lanes in "
                       f"{secs:.4f} s")
    if grown.cap <= 1 << 21:
        raise AssertionError("the growth run never grew the table")
    return launches, table


def check_gates(table, note, total=TOTAL_GATE, digest=HIST_GATE):
    tot = table.tot
    hd = hashlib.md5(np.ascontiguousarray(table.hist(), np.int64)
                     .tobytes()).hexdigest()[:12]
    log(f"  distinct {tot}, hist digest {hd}, {note}")
    if tot != total:
        raise AssertionError(f"wrong distinct count {tot} != {total}")
    if hd != digest:
        raise AssertionError(f"wrong histogram digest {hd} != {digest}")


# -- phase 5 ------------------------------------------------------------

def write_inputs(d):
    rng = np.random.default_rng(5)
    alph = np.frombuffer(b"ACGT", np.uint8)
    g = rng.integers(0, 4, 20_000)
    fq = os.path.join(d, "reads.fq")
    with open(fq, "wb") as f:
        for i in range(3000):
            s = rng.integers(0, len(g) - 120)
            r = g[s:s + 120]
            if rng.random() < 0.5:
                r = (3 - r)[::-1]
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, alph[r].tobytes(), b"I" * 120))
    fa = os.path.join(d, "contigs.fa")
    with open(fa, "wb") as f:
        for i in range(300):
            n = int(rng.integers(10, 700))
            s = rng.integers(0, len(g) - n)
            seq = alph[g[s:s + n]].copy()
            seq[rng.integers(0, n, max(1, n // 100))] = ord("N")
            f.write(b">c%d\n" % i)
            b = seq.tobytes()
            for j in range(0, len(b), 60):
                f.write(b[j:j + 60] + b"\n")
    return fq, fa


def cli_check():
    env = dict(os.environ, PYTHONPATH=ROOT)
    d = tempfile.mkdtemp(prefix="yak_tpu_torch_smoke_")
    try:
        for src in write_inputs(d):
            outs = {}
            for devname in ("cuda", "cpu"):
                out = os.path.join(d, f"out_{devname}.yak")
                cmd = [sys.executable, "-m", "yak_tpu_torch", "count",
                       "-k31", "-K", "200k", "--device", devname, "-o", out,
                       src]
                res = subprocess.run(cmd, capture_output=True, text=True,
                                     env=env, cwd=ROOT, timeout=300)
                if res.returncode != 0:
                    raise AssertionError(f"CLI failed on {devname}: "
                                         f"{res.stderr[-2000:]}")
                with open(out, "rb") as f:
                    outs[devname] = f.read()
            if outs["cuda"] != outs["cpu"]:
                raise AssertionError(f"{os.path.basename(src)}: CUDA and "
                                     f"CPU dumps differ")
            log(f"  {os.path.basename(src)}: CUDA and CPU dumps identical "
                f"({len(outs['cuda'])} bytes, md5 "
                f"{hashlib.md5(outs['cuda']).hexdigest()[:12]})")
    finally:
        for name in os.listdir(d):
            os.unlink(os.path.join(d, name))
        os.rmdir(d)

# -- phases 6-9: the lookup slice ---------------------------------------

def write_fasta(path, seqs, names=None):
    """bench.py:_write_fasta: one line per sequence."""
    alph = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as f:
        for j, s in enumerate(seqs):
            f.write(b">%s\n" % (names[j] if names else b"s%d" % j))
            f.write(alph[s].tobytes())
            f.write(b"\n")


def write_lookup_inputs(d, reads):
    """bench.py's qv read sets (seeds 100-102: 400,000 error-free 150 bp
    reads of the genome, bench.py:237-243) and phase 8's inputs: the
    genome as 20 contigs of 100,000 bp, and phase 4's error-bearing
    reads as FASTQ."""
    genome = np.random.default_rng(42).integers(0, 4, GENOME_LEN,
                                                dtype=np.uint8)
    paths = write_qv_sets(d, (100, *QV_SEEDS))
    paths["contigs"] = os.path.join(d, "contigs.fa")
    write_fasta(paths["contigs"], make_contigs(genome),
                [b"ctg%d" % i for i in range(N_CONTIGS)])
    paths["reads"] = os.path.join(d, "reads.fq")
    write_fastq(paths["reads"], reads)
    return paths


def write_fastq(path, reads):
    alph = np.frombuffer(b"ACGT", np.uint8)
    qual = b"I" * READ_LEN
    with open(path, "wb") as f:
        f.write(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, alph[r].tobytes(), qual)
                         for i, r in enumerate(reads)))


def write_qv_sets(d, seeds):
    """bench.py's qv read sets of `seeds` (400,000 error-free 150 bp reads
    of the genome each, bench.py:237-243); returns {seed: path}."""
    genome = np.random.default_rng(42).integers(0, 4, GENOME_LEN,
                                                dtype=np.uint8)
    paths = {}
    for seed in seeds:
        rng = np.random.default_rng(seed)
        starts = rng.integers(0, GENOME_LEN - READ_LEN + 1, N_READS)
        paths[seed] = os.path.join(d, f"qv_{seed}.fa")
        write_fasta(paths[seed], genome[starts[:, None]
                                        + np.arange(READ_LEN)[None, :]])
    return paths


def make_contigs(genome):
    """The genome as N_CONTIGS contigs with a substitution every
    SUB_EVERY bases (each a low run of K windows) and one novel stretch
    in contig 10 at stream bases 1,030,000-1,070,000, across the 2^20
    chunk edge (one low run of 40,030 windows that the host fold must
    join over the edge)."""
    rng = np.random.default_rng(7)
    contigs = []
    for i in range(N_CONTIGS):
        c = genome[i * CONTIG_LEN:(i + 1) * CONTIG_LEN].copy()
        pos = np.arange(SUB_EVERY // 2, CONTIG_LEN, SUB_EVERY)
        c[pos] = (c[pos] + rng.integers(1, 4, len(pos))) % 4
        contigs.append(c)
    i, a, b = NOVEL
    contigs[i][a:b] = (contigs[i][a:b] + rng.integers(1, 4, b - a)) % 4
    return contigs


def novel_row():
    """chkerr's row for the novel stretch (every base of it substituted):
    its windows start from a-K+1 to b-1."""
    i, a, b = NOVEL
    return f"ctg{i}\t{a - K + 1}\t{b + K - 1}\t{b - a + K - 1}"


def qv_opts():
    from yak_tpu_torch.models.qv import QvOpts

    return QvOpts(chunk_size=1 << 23)


CHKERR_CHUNKS = {"contigs": 1 << 20, "reads": 1 << 23}


def run_chkerr(table, path, chunk):
    from yak_tpu_torch.models.chkerr import ChkerrOpts, main_chkerr

    buf = io.StringIO()
    main_chkerr(ChkerrOpts(chunk_size=chunk), table, path, out=buf)
    torch.cuda.synchronize()
    return buf.getvalue()


def max_err(a, b):
    """Max absolute difference of two int tensors (0 for two empty)."""
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_join(args, label):
    from yak_tpu_torch.ops import merge

    got = merge.merge_join(*args)
    want = merge.merge_join_plain(*args)
    torch.cuda.synchronize()
    err = max_err(got, want)
    if err or got.shape != want.shape:
        raise AssertionError(f"{label}: JOIN kernel != plain (max abs err "
                             f"{err})")
    return err


def check_compact(args, label):
    from yak_tpu_torch.ops import compact

    got = compact.compact(*args)
    want = compact.compact_plain(*args)
    torch.cuda.synchronize()
    m = int(want[3])
    err = max([abs(int(got[3]) - m)]
              + [max_err(g[:m], w[:m]) for g, w in zip(got[:3], want[:3])])
    if err:
        raise AssertionError(f"{label}: compaction kernel != plain (n_kept "
                             f"{int(got[3])} vs {m}, max abs err {err})")
    return err


def lookup_kernel_checks(dev, table, paths, card):
    """Phase 6; returns {kernel: (max_abs_err, ms, plain_ms, device_ms,
    plain_device_ms)}."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_compact_cases import CASES as COMPACT_CASES
    from torch_compact_cases import CUDA_TILE as COMPACT_TILE
    from torch_compact_cases import offset_planes, random_planes
    from torch_join_cases import CASES as JOIN_CASES, expected, table_arrays
    from yak_tpu_torch.models.qv import run_qv
    from yak_tpu_torch.ops import compact, merge
    from yak_tpu_torch.ops.keys import INT64_MAX, u64_to_torch

    errs = {"merge_join": 0, "compact": 0}
    for name, build in JOIN_CASES.items():
        hs, cs, batch, valid, cap, stale = build()
        tk, tc, n = table_arrays(hs, cs, cap, stale)
        h = u64_to_torch(batch, dev)
        v = torch.from_numpy(valid).to(dev)
        qkeys, order = torch.sort(torch.where(v, h, INT64_MAX))
        args = (u64_to_torch(tk, dev), torch.from_numpy(tc).to(dev),
                torch.tensor(n, dtype=torch.int32, device=dev), qkeys,
                order.to(torch.int32))
        errs["merge_join"] = max(errs["merge_join"], check_join(args, name))
        if not np.array_equal(merge.merge_join(*args).cpu().numpy(),
                              expected(hs, cs, batch, valid)):
            raise AssertionError(f"{name}: JOIN kernel != numpy contract")
    log(f"  JOIN: {len(JOIN_CASES)} cases equal")
    tile = compact._library().yak_compact_tile()
    if tile != COMPACT_TILE:
        raise AssertionError(f"the compaction kernel's tile is {tile} lanes, "
                             f"the fixtures' CUDA_TILE {COMPACT_TILE}")
    log(f"  compaction tile {tile} lanes = the fixtures' CUDA_TILE")
    for name, (build, _pallas) in COMPACT_CASES.items():
        arrays = build()
        for offset in range(4):
            khi, klo, v = offset_planes(arrays, dev, offset)
            for planes, note in (((khi, klo, v), ""),
                                 ((khi, khi, v), ", klo = khi")):
                errs["compact"] = max(errs["compact"], check_compact(
                    planes, f"{name} at lane offset {offset}{note}"))
    log(f"  compaction: {len(COMPACT_CASES)} cases equal at each 4-byte "
        f"offset from a 16-byte boundary, with klo separate and klo = khi")

    # the lookup path's own calls, captured from a warm-up run of each
    with captured("merge", "merge_join") as qv_joins:
        cnt = run_qv(qv_opts(), paths[100], table, out=io.StringIO())
    qv_joins = [args for args, _kw in qv_joins]
    log(f"  qv warm-up set: cnt sum {int(cnt.sum())}, "
        f"{len(qv_joins)} JOIN calls captured")
    ch_joins, ch_compacts = [], []
    for name, chunk in CHKERR_CHUNKS.items():
        with captured("merge", "merge_join") as js, \
                captured("compact", "compact") as cs:
            text = run_chkerr(table, paths[name], chunk)
        ch_joins += [args for args, _kw in js]
        ch_compacts += [args for args, _kw in cs]
        log(f"  chkerr {name}: {text.count(chr(10))} rows, {len(js)} JOIN "
            f"and {len(cs)} compaction calls captured")
    if not qv_joins or not ch_compacts:
        raise AssertionError("the lookup path made no kernel call")
    for i, args in enumerate(qv_joins + ch_joins):
        errs["merge_join"] = max(errs["merge_join"],
                                 check_join(args, f"captured JOIN {i}"))
    for i, args in enumerate(ch_compacts):
        errs["compact"] = max(errs["compact"],
                              check_compact(args, f"captured compaction {i}"))
    log(f"  kernel == plain on all {len(qv_joins) + len(ch_joins)} captured "
        f"JOIN calls and {len(ch_compacts)} compaction calls")

    args = max(qv_joins, key=lambda a: a[3].numel())
    live, nq = int(args[2]), args[3].numel()
    # the live table's keys and counts, the query keys and lanes read
    # once, one value written a query
    out = {"merge_join": time_kernel(
        merge.merge_join, merge.merge_join_plain, args,
        (12 * live + 16 * nq) / HBM_BYTES_PER_S * 1e3, None,
        f"JOIN (cap {args[0].numel()}, live {live}, B {nq})", card)}
    out["merge_join"]["max_abs_err"] = errs["merge_join"]
    # the same JOIN with qidx the identity: its stores then coalesce, so
    # the difference is what the scattered stores at qidx cost
    iota = torch.arange(nq, dtype=torch.int32, device=dev)
    ident = time_ms(lambda: merge.merge_join(*args[:4], iota), 20)
    log(f"  JOIN with qidx the identity (coalesced stores): {ident[1]:.4f} "
        f"ms device only [{card}]")
    out["merge_join"]["identity_qidx_device_ms"] = ident[1]
    chkerr = time_compact(max(ch_compacts, key=lambda a: a[0].numel()),
                          "compaction (chkerr)", card)
    n, density, seed = DENSE_COMPACT
    dense = offset_planes(random_planes(n, density, seed), dev, 0)
    errs["compact"] = max(errs["compact"],
                          check_compact(dense, "dense compaction"))
    out["compact"] = dict(chkerr, max_abs_err=errs["compact"], shapes={
        "chkerr": chkerr,
        "dense": time_compact(dense, "compaction (dense)", card)})
    return out


def time_kernel(kernel, plain, args, bound, library, label, card):
    """A kernels-line entry for one call: the kernel, its plain version
    and (`library`, a callable or None) one PyTorch call computing the
    same function, timed on `args`."""
    ms = time_ms(lambda: kernel(*args), 20)
    plain_ms = time_ms(lambda: plain(*args), 5)
    lib_ms = None if library is None else time_ms(library, 20)[0]
    log(f"  {label}: kernel {ms[0]:.4f} ms, plain torch {plain_ms[0]:.4f} "
        f"ms back to back (device only: {ms[1]:.4f} / {plain_ms[1]:.4f} "
        f"ms), bound {bound:.4f} ms, library "
        f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'} [{card}]")
    return {"max_abs_err": 0, "ms": ms[0], "plain_ms": plain_ms[0],
            "device_ms": ms[1], "plain_device_ms": plain_ms[1],
            "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms}


def time_compact(args, label, card):
    """time_kernel for one compaction call, with its lanes `n` and kept
    lanes `kept`.  Bound: khi read once, klo and v read (where they are
    not khi's storage) and all three planes written for each kept lane.  Library call: boolean-mask
    indexing of the stacked planes."""
    from yak_tpu_torch.ops import compact

    khi, klo, v = args
    n, kept = khi.numel(), int((khi >= 0).sum())
    # a plane that shares an earlier plane's storage is read with it
    reads = len({p.data_ptr() for p in args} - {khi.data_ptr()})
    return dict(time_kernel(
        compact.compact, compact.compact_plain, args,
        (4 * n + (4 * reads + 12) * kept) / HBM_BYTES_PER_S * 1e3,
        lambda: torch.stack([khi, klo, v])[:, khi >= 0],
        f"{label} (n {n}, kept {kept})", card), n=n, kept=kept)


class _Timeline:
    """Stands in for ops.countstep inside models.qv: marks each chunk's
    phases with a CUDA event and the host clock ("start" as the lookup
    is queued, then "extract", "sort", "join", "post")."""

    def __init__(self, countstep):
        self.countstep, self.marks = countstep, []

    def __getattr__(self, attr):
        return getattr(self.countstep, attr)

    def mark(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev, time.perf_counter()))

    def lookup_chunk(self, *args, **kw):
        self.mark("start")
        return self.countstep.lookup_chunk(*args, hook=self.mark, **kw)

    def qv_join_post(self, *args, **kw):
        out = self.countstep.qv_join_post(*args, **kw)
        self.mark("post")
        return out

    def qv_lookup_seg(self, *args, **kw):
        self.mark("start")
        return self.countstep.qv_lookup_seg(*args, hook=self.mark, **kw)

    def qv_join_post_seg(self, *args, **kw):
        out = self.countstep.qv_join_post_seg(*args, **kw)
        self.mark("post")
        return out


def qv_path(table, paths, card):
    """Phase 7; returns the JOIN launches of the first timed run."""
    from yak_tpu_torch.ops import merge

    first = None
    for seed in QV_SEEDS:
        merge.merge_join.launches = 0
        qv_run(table, paths, seed, card)
        launches = merge.merge_join.launches
        log(f"  seed {seed}: JOIN launches {launches}")
        first = launches if first is None else first
        if launches <= 0:
            raise AssertionError("the qv path never launched the JOIN")
    return first


def qv_run(table, paths, seed, card, timeline=True):
    """One qv run of a seed's read set, its gates checked; prints the
    rate and, with `timeline`, the per-chunk split."""
    from yak_tpu_torch.models import qv

    n_lookups = N_READS * (READ_LEN - K + 1)
    tl = _Timeline(qv.countstep)
    if timeline:
        qv.countstep = tl
    try:
        t0 = time.perf_counter()
        cnt = qv.run_qv(qv_opts(), paths[seed], table, out=io.StringIO())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        qv.countstep = tl.countstep
    digest = QV_SEEDS[seed]
    dg = hashlib.md5(np.ascontiguousarray(cnt, np.int64)
                     .tobytes()).hexdigest()[:12]
    log(f"  seed {seed}: cnt sum {int(cnt.sum())}, cnt[0] {int(cnt[0])}, "
        f"digest {dg}; wall {wall:.4f} s, {n_lookups / wall:.1f} lookups/s "
        f"[{card}]")
    if int(cnt.sum()) != QV_SUM or int(cnt[0]) != 0 or dg != digest:
        raise AssertionError(f"qv seed {seed}: gates failed (want sum "
                             f"{QV_SUM}, cnt[0] 0, digest {digest})")
    busy = None
    if timeline:
        busy, _by_phase = split_chunks(tl.marks, card)
        if not any(v in os.environ for v in KNOB_VARS):
            ONE_DEVICE[f"qv {seed}"] = (wall, busy)
    return wall, busy


def split_chunks(marks, card):
    """Per-chunk device spans (CUDA events) and host spans of one marked
    lookup run, and the host time between chunks (ingest, packing, h2d);
    returns the device busy ms and the per-phase sums."""
    chunks, cur = [], None
    for m in marks:
        if m[0] == "start":
            cur = [m]
            chunks.append(cur)
        else:
            cur.append(m)
    busy, by_phase = 0.0, {}
    for i, c in enumerate(chunks):
        dev = [(b[0], a[1].elapsed_time(b[1])) for a, b in zip(c, c[1:])]
        host = [(b[0], (b[2] - a[2]) * 1e3) for a, b in zip(c, c[1:])]
        busy += sum(ms for _n, ms in dev)
        for n, ms in dev:
            by_phase[n] = by_phase.get(n, 0.0) + ms
        log(f"  chunk {i} device: " + ", ".join(
            f"{n} {ms:.4f} ms" for n, ms in dev) + f" [{card}]")
        log(f"  chunk {i} host:   " + ", ".join(
            f"{n} {ms:.4f} ms" for n, ms in host))
    between = sum(b[0][2] - a[-1][2] for a, b in zip(chunks, chunks[1:]))
    log(f"  device lookup+post {busy:.4f} ms over {len(chunks)} chunks; "
        f"host between chunks (read, pack, upload) {between * 1e3:.4f} ms")
    return busy, by_phase


def chkerr_path(table, paths, card):
    """Phase 8; returns the compaction launches of the reads run and
    {input: output text}."""
    from yak_tpu_torch.ops import compact, countstep, merge

    launches = 0
    texts = {}
    for name, chunk in CHKERR_CHUNKS.items():
        compact.compact.launches = 0
        merge.merge_join.launches = 0
        t0 = time.perf_counter()
        text = texts[name] = run_chkerr(table, paths[name], chunk)
        wall = time.perf_counter() - t0
        launches = compact.compact.launches
        rows = text.splitlines()
        log(f"  {name} (chunk {chunk}): {len(rows)} rows, md5 "
            f"{hashlib.md5(text.encode()).hexdigest()[:12]}, compaction "
            f"launches {launches}, JOIN launches "
            f"{merge.merge_join.launches}, wall {wall:.4f} s [{card}]")
        if launches <= 0 or merge.merge_join.launches <= 0:
            raise AssertionError(f"chkerr {name} never launched its kernels")
        for r in rows:
            f = r.split("\t")
            if len(f) != 4 or int(f[2]) - int(f[1]) != int(f[3]) + K - 1:
                raise AssertionError(f"chkerr {name}: malformed row {r!r}")
    if not rows:
        raise AssertionError("chkerr found no error run in the reads")
    rows = texts["contigs"].splitlines()
    n_subs = N_CONTIGS * (CONTIG_LEN // SUB_EVERY)
    if novel_row() not in rows or len(rows) < n_subs // 2:
        raise AssertionError(f"chkerr contigs: {len(rows)} rows, want about "
                             f"{n_subs} and {novel_row()!r}, the run "
                             f"joined across the chunk edge")
    log(f"  contigs: {novel_row()!r} joined across the 2^20 chunk edge")
    # the marker-budget overflow on the card: a budget of 64 markers a
    # chunk copies every marker from the compacted planes instead
    saved = countstep.CHKERR_MAX_RUNS
    countstep.CHKERR_MAX_RUNS = 64
    try:
        text = run_chkerr(table, paths["contigs"], CHKERR_CHUNKS["contigs"])
    finally:
        countstep.CHKERR_MAX_RUNS = saved
    if text != texts["contigs"]:
        raise AssertionError("chkerr contigs: the output past a marker "
                             "budget of 64 differs")
    log("  contigs at a marker budget of 64 (every chunk over it): output "
        "identical")
    return launches, texts


def lookup_cli_check():
    """Phase 9: qv -p and chkerr through the CLI entry point, on the card
    and on the CPU."""
    from yak_tpu_torch import cli

    d = tempfile.mkdtemp(prefix="yak_tpu_torch_smoke_")
    try:
        fq, fa = write_inputs(d)
        yak = os.path.join(d, "reads.yak")
        with contextlib.redirect_stderr(io.StringIO()):
            if cli.main(["count", "-k31", "-K16384", "--device", "cuda",
                         "-o", yak, fq]) != 0:
                raise AssertionError("CLI count failed")
        # chkerr at -c 12, near the reads' k-mer coverage, so that low
        # runs are many and some cross the 16384-base chunk edges
        for cmd in (["qv", "-p"], ["chkerr", "-c", "12"]):
            for src in (fq, fa):
                outs = {}
                for devname in ("cuda", "cpu"):
                    buf, err = io.StringIO(), io.StringIO()
                    with contextlib.redirect_stdout(buf), \
                            contextlib.redirect_stderr(err):
                        ret = cli.main([*cmd, "-K16384", "--device",
                                        devname, yak, src])
                    if ret != 0:
                        raise AssertionError(f"CLI {cmd[0]} failed on "
                                             f"{devname}: {err.getvalue()}")
                    outs[devname] = buf.getvalue()
                name = f"{' '.join(cmd)} {os.path.basename(src)}"
                if outs["cuda"] != outs["cpu"]:
                    raise AssertionError(f"{name}: CUDA and CPU stdout differ")
                log(f"  {name}: CUDA and CPU stdout identical "
                    f"({outs['cuda'].count(chr(10))} lines, md5 "
                    f"{hashlib.md5(outs['cuda'].encode()).hexdigest()[:12]})")
    finally:
        for name in os.listdir(d):
            os.unlink(os.path.join(d, name))
        os.rmdir(d)


# -- phases 10-14: the -b two-pass and k >= 32 ---------------------------

def reset_counts():
    """Every kernel launch count to 0 (the sort kernel's by
    instantiation; its total stays, for the check after phase 14)."""
    from yak_tpu_torch.ops import compact, merge, scan, sort

    merge.merge_reduce.launches = 0
    for mode in merge.merge_reduce.mode_launches:
        merge.merge_reduce.mode_launches[mode] = 0
    merge.merge_join.launches = 0
    compact.compact.launches = 0
    scan.last_set_lane.launches = 0
    for inst in sort.sort.mode_launches:
        sort.sort.mode_launches[inst] = 0


def read_counts():
    """The launch counts by kernels-line entry."""
    from yak_tpu_torch.ops import compact, merge, scan, sort

    modes = merge.merge_reduce.mode_launches
    return {"merge_reduce": modes["count"],
            "merge_reduce_weighted": modes["weighted"],
            "merge_reduce_wide": modes["wide"],
            "merge_join": merge.merge_join.launches,
            "compact": compact.compact.launches,
            "last_set_lane": scan.last_set_lane.launches,
            **{f"sort_{inst}": n
               for inst, n in sort.sort.mode_launches.items()}}


def check_launched(counts, needed, what):
    missing = [name for name in needed if counts[name] <= 0]
    log(f"  launches in {what}: " + ", ".join(
        f"{name} {n}" for name, n in counts.items() if n))
    if missing:
        raise AssertionError(f"{what} never launched {', '.join(missing)}")


class _FoldTimeline:
    """Stands in for ops.countstep inside the table module: marks each
    fold's phases with a CUDA event and the host clock ("start" as the
    fold is queued, then the table's phase names: "extract", "sort",
    "gate" on a gated fold, "merge", "finalize")."""

    def __init__(self, countstep):
        self.countstep, self.marks = countstep, []

    def __getattr__(self, attr):
        return getattr(self.countstep, attr)

    def mark(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev, time.perf_counter()))

    def count_step(self, *args, **kw):
        self.mark("start")
        kw["hook"] = self.mark
        return self.countstep.count_step(*args, **kw)


@contextlib.contextmanager
def fold_timeline():
    """Inside the block, every fold of every KmerTable is marked; yields
    the _FoldTimeline."""
    from yak_tpu_torch import table as table_mod

    tl = _FoldTimeline(table_mod.countstep)
    table_mod.countstep = tl
    try:
        yield tl
    finally:
        table_mod.countstep = tl.countstep


def fold_split(marks, wall_s, card, what):
    """Per-fold device spans of a marked run, their sums by phase, and
    the device busy and idle share of the wall; returns the busy ms."""
    folds, cur = [], None
    for m in marks:
        if m[0] == "start":
            cur = [m]
            folds.append(cur)
        else:
            cur.append(m)
    by_phase, busy = {}, 0.0
    for i, f in enumerate(folds):
        spans = [(b[0], a[1].elapsed_time(b[1])) for a, b in zip(f, f[1:])]
        busy += sum(ms for _n, ms in spans)
        for name, ms in spans:
            by_phase.setdefault(name, []).append(ms)
        log(f"  {what} fold {i} device: " + ", ".join(
            f"{n} {ms:.4f} ms" for n, ms in spans))
    log(f"  {what}: {len(folds)} folds; per fold on the device " + ", ".join(
        f"{n} {min(v):.4f}-{max(v):.4f} ms (sum {sum(v):.4f})"
        for n, v in by_phase.items()) + f"; device busy {busy:.4f} ms of "
        f"{wall_s * 1e3:.4f} ms wall, idle {1 - busy / (wall_s * 1e3):.4f} "
        f"[{card}]")
    return busy


def run_bloom(files, bf_shift, dev, cap_log2=23):
    """bench.py's bloom workload through models.count.count."""
    from yak_tpu_torch.models.count import CountOpts, count

    opt = CountOpts(k=K, bf_shift=bf_shift, cap_log2=cap_log2,
                    chunk_size=1 << 23, device=str(dev))
    with contextlib.redirect_stderr(io.StringIO()):
        table = count(files, opt)
    torch.cuda.synchronize()
    return table


def bloom_files(d, reads):
    """bench.py's bloom input (the reads as one single-line FASTA) under
    two paths: a hard link, not a symlink, so count takes the literal
    two-pass and not the same-file shortcut."""
    fa = os.path.join(d, "bloom_reads.fa")
    write_fasta(fa, reads)
    link = os.path.join(d, "bloom_reads_link.fa")
    os.link(fa, link)
    return [fa, link]


def bloom_paths(dev, card, d, reads):
    """Phase 10; returns ({path: launch counts}, {path: captured merge
    calls}, captured compaction calls of the -b24 gate posts)."""
    fa, link = bloom_files(d, reads)
    n_extract = 2 * N_READS * (READ_LEN - K + 1)   # bench.py:536
    counts, merges, compacts = {}, {}, []
    for name, bf_shift, files, needed in (
            ("b24 literal", 24, [fa, link],
             ("merge_reduce_weighted", "merge_reduce", "compact")),
            ("b37 literal", 37, [fa, link],
             ("merge_reduce_weighted", "merge_reduce")),
            ("b24 shortcut", 24, [fa, fa], ("merge_reduce",))):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with fold_timeline() as tl, \
                captured("merge", "merge_reduce") as ms, \
                captured("compact", "compact") as cs:
            t0 = time.perf_counter()
            table = run_bloom(files, bf_shift, dev)
            wall = time.perf_counter() - t0
        counts[name] = read_counts()
        check_gates(table, f"{name} -b{bf_shift}", BLOOM_DISTINCT,
                    BLOOM_HIST)
        check_launched(counts[name], needed, name)
        log(f"  {name}: wall {wall:.4f} s, {n_extract / wall:.1f} "
            f"extraction units/s (bench.py's 96,000,000 a pass pair), peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
            f"GiB [{card}]")
        busy = fold_split(tl.marks, wall, card, name)
        ONE_DEVICE[name] = (wall, busy)      # beside phase 36's engines
        if name != "b24 shortcut":
            merges[name] = ms
        if name == "b24 literal":
            compacts = [args for args, _kw in cs]
        del table
    return counts, merges, compacts


def k33_path(dev, card, chunks):
    """Phase 11; returns (launch counts, captured merge calls)."""
    n_kmers = N_READS * (READ_LEN - K33 + 1)
    reset_counts()
    with fold_timeline() as tl, captured("merge", "merge_reduce") as ms:
        t0 = time.perf_counter()
        table = run_count(chunks, dev, k=K33)
        wall = time.perf_counter() - t0
    counts = read_counts()
    check_gates(table, "k=33", K33_DISTINCT, K33_HIST)
    check_launched(counts, ("merge_reduce_wide",), "the k=33 count")
    log(f"  k=33 count wall {wall:.4f} s, {n_kmers / wall:.1f} k-mers/s "
        f"[{card}]")
    ONE_DEVICE["k33"] = (wall, fold_split(tl.marks, wall, card, "k33"))
    return counts, ms


def replay_paths(dev, chunks, d):
    """Phase 12; returns ({path: launch counts}, {path: captured merge
    calls})."""
    fa = os.path.join(d, "bloom_reads.fa")
    counts, merges = {}, {}
    for name, run, total, digest, needed in (
            ("b24 replay", lambda: run_bloom(
                [fa, os.path.join(d, "bloom_reads_link.fa")], 24, dev,
                cap_log2=REPLAY_CAP_LOG2), BLOOM_DISTINCT, BLOOM_HIST,
             ("merge_reduce_weighted", "merge_reduce", "compact")),
            ("k33 replay", lambda: run_count(
                chunks, dev, cap_log2=REPLAY_CAP_LOG2, k=K33),
             K33_DISTINCT, K33_HIST, ("merge_reduce_wide",))):
        reset_counts()
        with captured("merge", "merge_reduce") as ms:
            t0 = time.perf_counter()
            table = run()
            secs = time.perf_counter() - t0
        counts[name] = read_counts()
        check_gates(table, f"{name}: grown from cap 2^{REPLAY_CAP_LOG2} to "
                           f"{table.cap} lanes in {secs:.4f} s", total,
                    digest)
        check_launched(counts[name], needed, name)
        if table.cap <= 1 << REPLAY_CAP_LOG2:
            raise AssertionError(f"{name} never grew the table")
        merges[name] = ms
    return counts, merges


def merge_mode(kw):
    """The kernels-line entry of a merge-reduce call by its keywords."""
    return ("merge_reduce_wide" if kw.get("wide") else
            "merge_reduce_weighted" if kw.get("weights") is not None
            else "merge_reduce")


def mode_kernel_checks(dev, merges, compacts, card):
    """Phase 13: the mode cases, then every captured call; returns the
    kernels-line entries of the weighted and wide modes, the count
    mode's and the compaction's max abs errors, and the compaction's
    times at the sentinel post's shape (None without a captured call)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_merge_cases import (MODE_CASES, SIGN, expected,
                                   sorted_batch, sorted_table)
    from yak_tpu_torch.ops import merge
    from yak_tpu_torch.ops.keys import torch_to_u64, u64_to_torch

    err = {"merge_reduce": 0, "merge_reduce_weighted": 0,
           "merge_reduce_wide": 0}
    for name, build in MODE_CASES.items():
        hs, cs, batch, valid, w, cap, create, wide = build()
        tk, tc = sorted_table(hs, cs, cap, wide)
        bk, bw = sorted_batch(batch, valid, w, wide)
        args = (u64_to_torch(tk, dev), torch.from_numpy(tc).to(dev),
                torch.tensor(len(hs), dtype=torch.int32, device=dev),
                torch.from_numpy(bk).to(dev))
        kw = {"weights": None if bw is None else torch.from_numpy(bw).to(dev),
              "wide": wide}
        e = compare(merge, args, create, name, **kw)
        err[merge_mode(kw)] = max(err[merge_mode(kw)], e)
        ok, oc, ns, nn = merge.merge_reduce(*args, create, **kw)
        wk, wc, wsize, wnew = expected(hs, cs, batch, valid, cap, create, w,
                                       wide)
        keys = torch_to_u64(ok)[:len(wk)] ^ (SIGN if wide else np.uint64(0))
        if not (int(ns) == wsize and int(nn) == wnew
                and np.array_equal(keys, wk)
                and np.array_equal(oc.cpu().numpy()[:len(wc)], wc)):
            raise AssertionError(f"{name}: kernel != numpy contract")
    n_calls = 0
    for path, calls in merges.items():
        for i, (args, kw) in enumerate(calls):
            mode = merge_mode(kw)
            e = compare(merge, args[:4], args[4], f"{path} merge {i}", **kw)
            err[mode] = max(err[mode], e)
            n_calls += 1
    log(f"  kernel == plain on the {len(MODE_CASES)} mode cases and all "
        f"{n_calls} captured merge calls")
    cerr = 0
    for i, args in enumerate(compacts):
        cerr = max(cerr, check_compact(args, f"sentinel compaction {i}"))
    log(f"  compaction kernel == plain on all {len(compacts)} sentinel-post "
        f"calls")

    out = {}
    for name, path, pick in (
            ("merge_reduce_weighted", "b24 literal",
             lambda kw: kw.get("weights") is not None),
            ("merge_reduce_wide", "k33", lambda kw: kw.get("wide"))):
        calls = [(a, kw) for a, kw in merges[path] if pick(kw)]
        times = [time_merge(merge, a, kw, f"{path} {name} {i}")
                 for i, (a, kw) in enumerate(calls)]
        out[name] = mean_times(times, err[name],
                               f"the {len(calls)} {path} calls [{card}]")
    # pass 2's increment-only count-mode merges at the bloom shapes
    calls = [(a, kw) for a, kw in merges["b24 literal"]
             if kw.get("weights") is None]
    mean_times([time_merge(merge, a, kw, f"b24 pass-2 merge {i}")
                for i, (a, kw) in enumerate(calls)], err["merge_reduce"],
               f"the {len(calls)} b24 pass-2 calls [{card}]")
    sentinel = None
    if compacts:
        sentinel = time_compact(max(compacts, key=lambda a: a[0].numel()),
                                "compaction (-b24 sentinel post)", card)
    # the two -b24 gate posts on a pass-1 batch, from an empty filter
    from yak_tpu_torch.ops import bloom, countstep

    bkeys = next(a[3] for a, kw in merges["b24 literal"]
                 if kw.get("weights") is not None)
    bf = bloom.make_bloom(24, dev)
    for post in (countstep.bloom_gate_sentinel_post,
                 countstep.bloom_gate_post):
        ms = time_ms(lambda: post(bkeys, bf, 10, 24, 4), 5)
        log(f"  {post.__name__} at -b24 (B {bkeys.numel()}): {ms[0]:.4f} ms "
            f"back to back, {ms[1]:.4f} ms device only [{card}]")
    return out, err["merge_reduce"], cerr, sentinel


def count_cli_check(psort=False):
    """Phase 14: count -b24 over two files and count -k33 through the CLI
    entry point, on the card and on the CPU.  With `psort` (phase 16):
    count -k31 of phase 5's FASTQ and FASTA under the psort engine,
    whose CUDA runs must launch the sort kernel."""
    from yak_tpu_torch import cli

    d = tempfile.mkdtemp(prefix="yak_tpu_torch_smoke_")
    try:
        fq, fa = write_inputs(d)
        arg_sets = ([["-k31", fq], ["-k31", fa]] if psort
                    else [["-b24", fq, fa], ["-k33", fq]])
        for args in arg_sets:
            outs = {}
            for devname in ("cuda", "cpu"):
                out = os.path.join(d, f"out_{devname}.yak")
                err = io.StringIO()
                reset_counts()
                with contextlib.redirect_stderr(err), (
                        psort_engine() if psort
                        else contextlib.nullcontext()):
                    ret = cli.main(["count", "-K200k", "--device", devname,
                                    "-o", out, *args])
                if psort and devname == "cuda":
                    check_launched(read_counts(), ("sort_i64",),
                                   f"psort CLI count {args[-1]}")
                if ret != 0:
                    raise AssertionError(f"CLI count {args[0]} failed on "
                                         f"{devname}: {err.getvalue()}")
                with open(out, "rb") as f:
                    outs[devname] = f.read()
            name = " ".join([args[0], os.path.basename(args[1])])
            if outs["cuda"] != outs["cpu"]:
                raise AssertionError(f"count {name}: CUDA and CPU dumps "
                                     f"differ")
            log(f"  count {name}: CUDA and CPU dumps identical "
                f"({len(outs['cuda'])} bytes, md5 "
                f"{hashlib.md5(outs['cuda']).hexdigest()[:12]})")
    finally:
        for name in os.listdir(d):
            os.unlink(os.path.join(d, name))
        os.rmdir(d)


# -- phases 15-16: the psort engine -------------------------------------

@contextlib.contextmanager
def psort_engine():
    """YAK_TPU_PSORT=1 inside the block (the port reads it at each fold
    and at each qv or chkerr run), unset after."""
    os.environ["YAK_TPU_PSORT"] = "1"
    try:
        yield
    finally:
        del os.environ["YAK_TPU_PSORT"]


def psort_workloads(dev, card, chunks, files, paths, ch_texts, timed):
    """Phase 16's workloads under the psort engine, each with its gates,
    and with the launch counts set to 0 just before it and read just
    after; with `timed`, the per-fold and per-chunk splits.  Returns
    {path: launch counts}."""
    counts = {}

    def done(name, needed):
        counts[name] = read_counts()
        check_launched(counts[name], needed, name)
        if counts[name]["compact"]:
            raise AssertionError(f"{name} launched the compaction kernel")

    with psort_engine():
        table = None
        for name, k, total, digest, needed in (
                ("psort count", K, TOTAL_GATE, HIST_GATE,
                 ("sort_i64", "merge_reduce")),
                ("psort k33", K33, K33_DISTINCT, K33_HIST,
                 ("sort_i64", "merge_reduce_wide"))):
            reset_counts()
            with fold_timeline() as tl:
                t0 = time.perf_counter()
                counted = run_count(chunks, dev, k=k)
                wall = time.perf_counter() - t0
            done(name, needed)
            check_gates(counted, name, total, digest)
            log(f"  {name} wall {wall:.4f} s, "
                f"{N_READS * (READ_LEN - k + 1) / wall:.1f} k-mers/s [{card}]")
            if timed:
                fold_split(tl.marks, wall, card, name)
            if k == K:
                table = counted
            del counted

        name = "psort b24 literal"
        reset_counts()
        with fold_timeline() as tl:
            t0 = time.perf_counter()
            gated = run_bloom(files, 24, dev)
            wall = time.perf_counter() - t0
        done(name, ("sort_i64", "merge_reduce_weighted", "merge_reduce"))
        check_gates(gated, name, BLOOM_DISTINCT, BLOOM_HIST)
        del gated
        log(f"  {name}: wall {wall:.4f} s, "
            f"{2 * N_READS * (READ_LEN - K + 1) / wall:.1f} extraction "
            f"units/s [{card}]")
        if timed:
            fold_split(tl.marks, wall, card, name)

        reset_counts()
        qv_run(table, paths, 101, card, timeline=timed)
        done("psort qv", ("sort_i64_i32", "sort_i32", "merge_join"))

        reset_counts()
        for name, chunk in CHKERR_CHUNKS.items():
            t0 = time.perf_counter()
            text = run_chkerr(table, paths[name], chunk)
            wall = time.perf_counter() - t0
            if text != ch_texts[name]:
                raise AssertionError(f"psort chkerr {name}: output differs "
                                     f"from phase 8's")
            log(f"  psort chkerr {name}: {text.count(chr(10))} rows, md5 "
                f"{hashlib.md5(text.encode()).hexdigest()[:12]} (phase 8's),"
                f" wall {wall:.4f} s [{card}]")
        done("psort chkerr", ("sort_i64_i32", "sort_i32_i32", "merge_join"))
    return counts


def check_sort(args, label):
    """Sort kernel vs plain on one (keys, payload): bit-equal, the input
    planes unchanged, and the kernel's pass count equal to the plain
    plan's (ops/sort.plan_plain), else raises; returns the pass count."""
    from yak_tpu_torch.ops import sort

    keys, pay = args
    before = [a.clone() for a in args if a is not None]
    got = sort.sort(*args)
    want = sort.sort_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0])
            and (pay is None or torch.equal(got[1], want[1]))):
        raise AssertionError(f"{label}: sort kernel != plain")
    if not all(torch.equal(a, b) for a, b in
               zip(before, (a for a in args if a is not None))):
        raise AssertionError(f"{label}: the sort kernel wrote its input")
    if keys.numel() == 0:
        return 0
    passes, plain = int(sort.sort.passes), len(sort.plan_plain(*args))
    if passes != plain:
        raise AssertionError(f"{label}: the kernel ran {passes} passes, the "
                             f"plain plan {plain}")
    return passes


def sort_kernel_checks(dev, card, chunks, files, paths, ch_texts):
    """Phase 15; returns the kernels-line entries of the sort's
    instantiations."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_sort_cases import CASES
    from yak_tpu_torch.ops import sort

    for name, build in CASES.items():
        keys, pay = build()
        check_sort((torch.from_numpy(keys).to(dev),
                    None if pay is None else torch.from_numpy(pay).to(dev)),
                   name)
    log(f"  {len(CASES)} cases equal, inputs unchanged, pass counts as "
        f"planned")
    with captured("sort", "sort") as calls:
        psort_workloads(dev, card, chunks, files, paths, ch_texts,
                        timed=False)
    calls = [(a[0], a[1] if len(a) > 1 else None) for a, _kw in calls]
    passes = [check_sort(args, f"captured sort {i}")
              for i, args in enumerate(calls)]
    log(f"  kernel == plain on all {len(calls)} sort calls captured from a "
        f"warm-up run of phase 16's workloads, inputs unchanged, pass "
        f"counts as planned")

    out = {}
    for inst in SORT_INSTANCES:
        mine = [i for i, a in enumerate(calls) if sort.instance(*a) == inst]
        if not mine:
            raise AssertionError(f"the psort engine made no sort_{inst} call")
        i = max(mine, key=lambda i: calls[i][0].numel())
        keys, pay = calls[i]
        n = keys.numel()
        # each input lane read once and each output lane written once
        lane_bytes = keys.element_size() + (0 if pay is None else 4)
        out[f"sort_{inst}"] = time_kernel(
            sort.sort, sort.sort_plain, (keys, pay),
            2 * n * lane_bytes / HBM_BYTES_PER_S * 1e3,
            lambda keys=keys: torch.sort(keys),
            f"sort_{inst} (n {n}, {passes[i]} passes, the plain plan's "
            f"{len(sort.plan_plain(keys, pay))}; the largest of {len(mine)} "
            f"calls; library: torch.sort of the keys)", card)
        out[f"sort_{inst}"]["passes"] = passes[i]
    return out


# -- phases 17-23: trio binning and evaluation ----------------------------

def trio_sets(d, genome, seeds):
    """bench.py:305-309 and 482-486: each seed's 24 contigs, the genome
    rotated at random offsets, as one-line FASTA (names s0..s23)."""
    paths = {}
    for seed in seeds:
        rng = np.random.default_rng(seed)
        paths[seed] = os.path.join(d, f"trio_{seed}.fa")
        write_fasta(paths[seed], [np.roll(genome, int(r)) for r in
                                  rng.integers(0, GENOME_LEN, TRIO_CONTIGS)])
    return paths


def trio_tables(dev, count_items, genome):
    """bench.py's two flag tables on the card: triobin's from phase 4's
    keys, flag (h >> 7) % 15 + 1 (bench.py:297-300); trioeval's from the
    port's own extraction of the genome, 2 and 8 in alternating 10 kb
    blocks, the first occurrence of a hash kept (bench.py:466-476)."""
    from yak_tpu_torch.io.pack import pack_planes
    from yak_tpu_torch.ops.keys import torch_to_u64, u32_to_torch
    from yak_tpu_torch.ops.kmers import extract_from_planes
    from yak_tpu_torch.table import KmerTable

    h, _c = count_items
    tb = KmerTable(K, device=dev)
    tb._set_pairs(h, ((h >> np.uint64(7)) % np.uint64(15)
                      + np.uint64(1)).astype(np.int32))
    planes = [u32_to_torch(p, dev) for p in pack_planes(genome[None, :])]
    gh, valid = extract_from_planes(*planes, K, GENOME_LEN)
    if not bool(valid.all()):
        raise AssertionError("the genome has an invalid window")
    gh = torch_to_u64(gh.reshape(-1))
    pos_flag = np.where((np.arange(len(gh)) // 10_000) % 2 == 0, 2, 8)
    keys, first = np.unique(gh, return_index=True)
    te = KmerTable(K, device=dev)
    te._set_pairs(keys, pos_flag[first].astype(np.int32))
    log(f"  triobin table {tb.tot} keys, trioeval table {te.tot} keys")
    return tb, te


def trio_opts(**kw):
    from yak_tpu_torch.models.trio import TrioOpts

    return TrioOpts(**kw)


class _LookupTimeline:
    """Stands in for ops.countstep inside models.trio or models.scan, or
    the table module: marks each chunk's phases with a CUDA event and
    the host clock ("start" as the lookup is queued, then
    "extract", "sort", "join", "post" after the typing and the reduction,
    the marker mid or sexchr's sums, "markers" after the compaction or
    the marker sort); a batch of raw hashes (lookup_keys) is marked
    "start", "sort", "join"."""

    def __init__(self, countstep):
        self.countstep, self.marks = countstep, []

    def __getattr__(self, attr):
        fn = getattr(self.countstep, attr)
        if attr == "marker_step":     # the run's marker step, marked
            return lambda *a, **kw: self._marked(fn(*a, **kw), "markers")
        name = {"triobin_reduce": "post", "trioeval_mark_mid": "post",
                "sexchr_reduce": "post"}.get(attr)
        return fn if name is None else self._marked(fn, name)

    def _marked(self, fn, name):
        def marked(*args, **kw):
            out = fn(*args, **kw)
            self.mark(name)
            return out
        return marked

    def mark(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev, time.perf_counter()))

    def lookup_chunk(self, *args, **kw):
        self.mark("start")
        return self.countstep.lookup_chunk(*args, hook=self.mark, **kw)

    def lookup_keys(self, *args, **kw):
        self.mark("start")
        return self.countstep.lookup_keys(*args, mark=self.mark, **kw)


class _Sink:
    """A stdout for the trio runs: the md5 of every byte, and the text
    without its -p D rows."""

    def __init__(self):
        self.md5, self.kept, self.d_rows = hashlib.md5(), [], 0

    def write(self, s):
        self.md5.update(s.encode())
        kept = re.sub(r"^D\t[^\n]*\n", "", s, flags=re.M)
        self.d_rows += s.count("\n") - kept.count("\n")
        self.kept.append(kept)

    def digest(self):
        return self.md5.hexdigest()[:12]

    def text(self):
        return "".join(self.kept)


def trio_run(cmd, table, path, opt, timeline=False):
    """One triobin or trioeval run; returns (the sink, wall s, the
    timeline's marks or None)."""
    from yak_tpu_torch.models import trio

    sink = _Sink()
    tl = _LookupTimeline(trio.countstep)
    if timeline:
        trio.countstep = tl
    fn = trio.main_triobin if cmd == "triobin" else trio.main_trioeval
    try:
        t0 = time.perf_counter()
        fn(opt, table, path, out=sink)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        trio.countstep = tl.countstep
    return sink, wall, tl.marks if timeline else None


def trio_gated(cmd, table, paths, seeds, digests, card, label):
    """The gated runs of one workload (each seed's md5[:12] against
    `digests`) with the per-chunk split on the device timeline, with the
    launch counts set to 0 just before the runs and read just after;
    returns ({seed: text}, launch counts)."""
    npos = TRIO_CONTIGS * (GENOME_LEN - K + 1)
    texts = {}
    reset_counts()
    for seed in seeds:
        sink, wall, marks = trio_run(cmd, table, paths[seed], trio_opts(),
                                     timeline=True)
        texts[seed] = sink.text()
        log(f"  {label} seed {seed}: md5 {sink.digest()} (gate "
            f"{digests[seed]}), {texts[seed].count(chr(10))} lines; wall "
            f"{wall:.4f} s, {npos / wall:.1f} positions/s [{card}]")
        if sink.digest() != digests[seed]:
            raise AssertionError(f"{label} seed {seed}: digest "
                                 f"{sink.digest()} != {digests[seed]}")
        busy, by_phase = split_chunks(marks, card)
        log(f"  {label} seed {seed}: device by phase " + ", ".join(
            f"{n} {ms:.4f} ms" for n, ms in by_phase.items())
            + f"; busy {busy:.4f} ms of {wall * 1e3:.4f} ms wall, idle "
            f"{1 - busy / (wall * 1e3):.4f} [{card}]")
    return texts, read_counts()


def trio_kernel_checks(tb, te, warm, card):
    """Phase 17: every JOIN, compaction and sort call of a triobin -p
    run (the first 4 contigs of the warm-up set, one full chunk) and a
    trioeval run (the warm-up set), on both engines, held against the
    plain versions; the largest call of each kind timed.  Returns
    {kernel: (max abs err, {shape: entry})}."""
    from yak_tpu_torch.ops import merge, sort

    small = warm["triobin_small"]
    with captured("merge", "merge_join") as js, \
            captured("compact", "compact") as cs:
        trio_run("triobin", tb, small, trio_opts(print_diff=True))
        n_tb = len(cs)
        trio_run("trioeval", te, warm["trioeval"], trio_opts())
    with psort_engine(), captured("sort", "sort") as ss:
        trio_run("triobin", tb, small, trio_opts(print_diff=True))
        trio_run("trioeval", te, warm["trioeval"], trio_opts())
    joins = [a for a, _kw in js]
    compacts = [a for a, _kw in cs]
    sorts = [(a[0], a[1] if len(a) > 1 else None) for a, _kw in ss]
    if not (joins and n_tb and len(compacts) > n_tb and sorts):
        raise AssertionError("the trio paths made no JOIN, compaction or "
                             "sort call")
    err = {"merge_join": max(check_join(a, f"trio JOIN {i}")
                             for i, a in enumerate(joins)),
           "compact": max(check_compact(a, f"trio compaction {i}")
                          for i, a in enumerate(compacts))}
    for i, a in enumerate(sorts):
        check_sort(a, f"trio sort {i}")    # raises unless bit-equal
    log(f"  kernel == plain on all {len(joins)} JOIN, {len(compacts)} "
        f"compaction and {len(sorts)} sort calls of the trio paths")
    args = max(joins, key=lambda a: a[3].numel())
    live, nq = int(args[2]), args[3].numel()
    shapes = {"merge_join": {"triobin": time_kernel(
        merge.merge_join, merge.merge_join_plain, args,
        (12 * live + 16 * nq) / HBM_BYTES_PER_S * 1e3, None,
        f"trio JOIN (cap {args[0].numel()}, live {live}, B {nq})", card)},
        "compact": {
            "triobin_diff": time_compact(compacts[0], "compaction (triobin "
                                         "-p)", card),
            "trioeval": time_compact(compacts[-1],
                                     "compaction (trioeval)", card)}}
    for inst, label in (("i64_i32", "query"), ("i32_i32", "trioeval"),
                        ("i32", "triobin_diff")):
        mine = [a for a in sorts if sort.instance(*a) == inst]
        if not mine:
            raise AssertionError(f"the trio psort paths made no sort_{inst} "
                                 f"call")
        keys, pay = max(mine, key=lambda a: a[0].numel())
        n = keys.numel()
        lane_bytes = keys.element_size() + (0 if pay is None else 4)
        shapes[f"sort_{inst}"] = {label: time_kernel(
            sort.sort, sort.sort_plain, (keys, pay),
            2 * n * lane_bytes / HBM_BYTES_PER_S * 1e3,
            lambda keys=keys: torch.sort(keys),
            f"trio sort_{inst} ({label}, n {n}, {len(mine)} calls)", card)}
    return {name: (err.get(name, 0), shapes[name]) for name in shapes}


def triobin_p_path(tb, paths, gated_text, card):
    """Phase 19: triobin -p on seed 7 on both engines: the output less
    its D rows is the gated run's, the psort engine's bytes the default
    engine's; past the marker budget a chunk copies every marker from
    the device.  Returns {path: launch counts}."""
    from yak_tpu_torch.ops import countstep

    counts, digests = {}, {}
    for name, ctx, needed in (
            ("triobin -p", contextlib.nullcontext(),
             ("merge_join", "compact")),
            ("psort triobin -p", psort_engine(),
             ("merge_join", "sort_i64_i32", "sort_i32"))):
        reset_counts()
        with ctx:
            sink, wall, _ = trio_run("triobin", tb, paths[7],
                                     trio_opts(print_diff=True))
        counts[name] = read_counts()
        check_launched(counts[name], needed, name)
        digests[name] = sink.digest()
        n_chunks = counts[name]["merge_join"]
        log(f"  {name} seed 7: {sink.d_rows} D rows over {n_chunks} chunks "
            f"(budget {countstep.TRIOBIN_MAX_DIFF} a chunk), md5 "
            f"{sink.digest()}, wall {wall:.4f} s [{card}]")
        if sink.text() != gated_text:
            raise AssertionError(f"{name}: the output less its D rows "
                                 f"differs from the gated run's")
        if sink.d_rows <= n_chunks * countstep.TRIOBIN_MAX_DIFF:
            raise AssertionError(f"{name}: no chunk passed the marker budget")
    if digests["triobin -p"] != digests["psort triobin -p"]:
        raise AssertionError("triobin -p: the psort engine's output differs")
    log("  the output less its D rows is the gated run's; both engines "
        "print the same bytes")
    return counts


def restore_into_path(dev, d, count_items, reads, card):
    """Phase 21: phase 4's table dumped as pat, the -b24 table (the
    same-file shortcut, phase 10's table) as mat, load_trio_tables on
    the card and on the CPU: the same keys and flags."""
    from yak_tpu_torch.io.yakfmt import dump_yak
    from yak_tpu_torch.models.trio import load_trio_tables

    pat, mat = os.path.join(d, "pat.yak"), os.path.join(d, "mat.yak")
    dump_yak(pat, K, 10, *count_items)
    fa = os.path.join(d, "bloom_reads.fa")
    write_fasta(fa, reads)
    b24 = run_bloom([fa, fa], 24, dev)
    check_gates(b24, "the -b24 mat table", BLOOM_DISTINCT, BLOOM_HIST)
    b24.dump(mat)
    del b24
    out = []
    for where in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        t = load_trio_tables(pat, mat, trio_opts(), where)
        tot = t.tot                     # reads the size back: settled
        secs = time.perf_counter() - t0
        out.append(t.items())
        log(f"  load_trio_tables on {where}: {tot} keys in {secs:.4f} s"
            + (f" [{card}]" if where.type == "cuda" else ""))
    (hc, vc), (hp, vp) = out
    if not (np.array_equal(hc, hp) and np.array_equal(vc, vp)):
        raise AssertionError("restore-into: card and CPU tables differ")
    # at min_cnt 2 the pat file keeps exactly the keys counted twice or
    # more, which are the -b24 table's keys: every key takes both flags
    both = int((((vc & 3) > 0) & ((vc >> 2) > 0)).sum())
    if not len(hc) == both == BLOOM_DISTINCT:
        raise AssertionError(f"restore-into: {len(hc)} keys, {both} with "
                             f"both flags, want {BLOOM_DISTINCT}")
    log(f"  card and CPU tables equal: {len(hc)} keys, each with pat and "
        f"mat flags")


def trio_cli_check():
    """Phase 23: triobin -p, trioeval -e, and qv -p / chkerr against a
    k=33 table, through the CLI entry point on the card and on the CPU,
    chunk 16384, on phase 5's inputs: pat counted from the FASTQ, mat
    from the FASTA, the FASTA as the child."""
    from yak_tpu_torch import cli

    d = tempfile.mkdtemp(prefix="yak_tpu_torch_smoke_")
    try:
        fq, fa = write_inputs(d)
        yak = {name: os.path.join(d, f"{name}.yak")
               for name in ("pat", "mat", "k33")}
        with contextlib.redirect_stderr(io.StringIO()):
            for name, args in (("pat", ["-k31", fq]), ("mat", ["-k31", fa]),
                               ("k33", ["-k33", fq])):
                if cli.main(["count", "-K16384", "--device", "cuda", "-o",
                             yak[name], *args]) != 0:
                    raise AssertionError(f"CLI count {name} failed")
        for cmd in (["triobin", "-p", yak["pat"], yak["mat"], fa],
                    ["trioeval", "-e", yak["pat"], yak["mat"], fa],
                    ["qv", "-p", yak["k33"], fa], ["qv", "-p", yak["k33"], fq],
                    ["chkerr", "-c", "12", yak["k33"], fa],
                    ["chkerr", "-c", "12", yak["k33"], fq]):
            outs = {}
            for devname in ("cuda", "cpu"):
                buf, err = io.StringIO(), io.StringIO()
                with contextlib.redirect_stdout(buf), \
                        contextlib.redirect_stderr(err):
                    ret = cli.main([cmd[0], "-K16384", "--device", devname,
                                    *cmd[1:]])
                if ret != 0:
                    raise AssertionError(f"CLI {cmd[0]} failed on {devname}:"
                                         f" {err.getvalue()}")
                outs[devname] = buf.getvalue()
            name = " ".join(os.path.basename(a) for a in cmd)
            if outs["cuda"] != outs["cpu"] or not outs["cuda"]:
                raise AssertionError(f"{name}: CUDA and CPU stdout differ")
            log(f"  {name}: CUDA and CPU stdout identical "
                f"({outs['cuda'].count(chr(10))} lines, md5 "
                f"{hashlib.md5(outs['cuda'].encode()).hexdigest()[:12]})")
    finally:
        for name in os.listdir(d):
            os.unlink(os.path.join(d, name))
        os.rmdir(d)


def trio_phases(dev, card, count_items, reads, results, by_path):
    """Phases 17-23."""
    genome = np.random.default_rng(42).integers(0, 4, GENOME_LEN,
                                                dtype=np.uint8)
    d = tempfile.mkdtemp(prefix="yak_tpu_torch_trio_")
    try:
        t0 = time.perf_counter()
        tb_paths = trio_sets(d, genome, (6, *TB_DIGEST))
        te_paths = trio_sets(d, genome, (16, *TE_DIGEST))
        small = os.path.join(d, "trio_6_small.fa")
        rng = np.random.default_rng(6)
        write_fasta(small, [np.roll(genome, int(r)) for r in
                            rng.integers(0, GENOME_LEN, TRIO_CONTIGS)[:4]])
        tb, te = trio_tables(dev, count_items, genome)
        log(f"  trio inputs and tables made in {time.perf_counter() - t0:.3f}"
            f" s")

        phase("17. trio lookup kernels vs plain torch on the card")
        for name, (err, shapes) in trio_kernel_checks(
                tb, te, {"triobin_small": small, "trioeval": te_paths[16]},
                card).items():
            r = results[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r.setdefault("shapes", {}).update(shapes)

        phase("18. triobin at real size")
        trio_run("triobin", tb, tb_paths[6], trio_opts())   # warm-up set
        tb_texts, by_path["triobin"] = trio_gated(
            "triobin", tb, tb_paths, TB_DIGEST, TB_DIGEST, card, "triobin")
        check_launched(by_path["triobin"], ("merge_join",), "triobin")

        phase("19. triobin -p at real size")
        by_path.update(triobin_p_path(tb, tb_paths, tb_texts[7], card))

        phase("20. trioeval at real size")
        te_texts, by_path["trioeval"] = trio_gated(
            "trioeval", te, te_paths, TE_DIGEST, TE_DIGEST, card,
            "trioeval")
        check_launched(by_path["trioeval"], ("merge_join", "compact"),
                       "trioeval")

        phase("21. restore-into at real size")
        restore_into_path(dev, d, count_items, reads, card)

        phase("22. the psort engine on the trio paths")
        with psort_engine():
            for cmd, table, paths, seed, gates, texts, needed in (
                    ("triobin", tb, tb_paths, 7, TB_DIGEST, tb_texts,
                     ("merge_join", "sort_i64_i32")),
                    ("trioeval", te, te_paths, 17, TE_DIGEST, te_texts,
                     ("merge_join", "sort_i64_i32", "sort_i32_i32"))):
                name = f"psort {cmd}"
                got, by_path[name] = trio_gated(
                    cmd, table, paths, (seed,), gates, card, name)
                check_launched(by_path[name], needed, name)
                if by_path[name]["compact"]:
                    raise AssertionError(f"{name} launched the compaction "
                                         f"kernel")
                if got[seed] != texts[seed]:
                    raise AssertionError(f"{name}: output differs")
    finally:
        for name in os.listdir(d):
            os.unlink(os.path.join(d, name))
        os.rmdir(d)

    phase("23. trio and k=33 lookup CLI on the card vs on the CPU")
    trio_cli_check()


# -- phases 24-28: the table algebra, print, inspect, sexchr, groupxy ----

ISEC_DISTINCT = BLOOM_DISTINCT       # isec by the -b24 table keeps its keys
SUBTRACT_DISTINCT = TOTAL_GATE - BLOOM_DISTINCT      # 4,181,874
SEXCHR_REGIONS = {"chrY": (0, 300_000), "chrX": (300_000, 1_300_000),
                  "PAR": (1_300_000, 1_400_000)}
SEXCHR_SEEDS = (7, 8)                # hap1, hap2: trio_sets' rotation sets
ASM_SUBS = ((0, 0), (2_000, 1_000), (1_500, 700))   # (every, offset) a file
# md5[:12] of each output, as `yak_tpu` prints it on the CPU for the same
# seeded inputs (tools/algebra_gates.py)
ALGEBRA_DIGEST = {"subtract": "b9609b6779e6", "isec": "864f158dde17",
                  "cntasm": "86aa85c861d1", "print": "1eed1bf68596",
                  "inspect": "ecaee28d02e1", "inspect2": "36d6ae9f28e6",
                  "sexchr": "44a7eb378f20", "groupxy": "ca6447e15ff6"}


class _Digest:
    """A stdout that keeps only the md5 of its bytes and their lines."""

    def __init__(self):
        self.md5, self.lines = hashlib.md5(), 0

    def write(self, s):
        self.md5.update(s.encode())
        self.lines += s.count("\n")

    def digest(self):
        return self.md5.hexdigest()[:12]


def file_md5(path):
    with open(path, "rb") as f:
        return hashlib.md5(f.read()).hexdigest()[:12]


def check_digest(name, got):
    if got != ALGEBRA_DIGEST[name]:
        raise AssertionError(f"{name}: md5 {got} != {ALGEBRA_DIGEST[name]}")


def algebra_files(d, genome, reads):
    """The sequence inputs of phases 24-27 (numpy only; also what
    tools/algebra_gates.py gives `yak_tpu`): the reads phase 4 counted
    as one-line FASTA; three assemblies, the genome as 20 contigs of
    100 kbp with no substitution, one every 2 kbp from base 1000, and
    one every 1.5 kbp from base 700; the chrY, chrX and PAR stretches of
    the genome (SEXCHR_REGIONS); and hap1 and hap2, the rotation sets of
    trio seeds 7 and 8 (24 rotations of the genome a set) cut into
    contigs of 100 kbp, which span the 2^23-base chunks."""
    paths = {"reads": os.path.join(d, "reads.fa")}
    write_fasta(paths["reads"], reads)
    for i, (every, offset) in enumerate(ASM_SUBS):
        g = genome.copy()
        if every:
            rng = np.random.default_rng(60 + i)
            pos = np.arange(offset, GENOME_LEN, every)
            g[pos] = (g[pos] + rng.integers(1, 4, len(pos))) % 4
        paths[f"asm{i}"] = os.path.join(d, f"asm{i}.fa")
        write_fasta(paths[f"asm{i}"], np.split(g, N_CONTIGS),
                    [b"asm%d_%d" % (i, j) for j in range(N_CONTIGS)])
    paths.update(sexchr_files(d, genome))
    return paths


def sexchr_files(d, genome):
    """sexchr's inputs (phases 26 and 34): the chrY, chrX and PAR
    stretches of the genome (SEXCHR_REGIONS), and hap1 and hap2, the
    rotation sets of trio seeds 7 and 8 cut into contigs of 100 kbp."""
    paths = {}
    for name, (a, b) in SEXCHR_REGIONS.items():
        paths[name] = os.path.join(d, f"{name}.fa")
        write_fasta(paths[name], [genome[a:b]], [name.encode()])
    for hap, seed in enumerate(SEXCHR_SEEDS, start=1):
        rng = np.random.default_rng(seed)
        rot = [np.roll(genome, int(r))
               for r in rng.integers(0, GENOME_LEN, TRIO_CONTIGS)]
        paths[f"hap{hap}"] = os.path.join(d, f"hap{hap}.fa")
        write_fasta(paths[f"hap{hap}"],
                    [c for g in rot for c in np.split(g, N_CONTIGS)],
                    [b"h%d_s%d_%d" % (hap, i, j)
                     for i in range(TRIO_CONTIGS) for j in range(N_CONTIGS)])
    return paths


def algebra_tables(dev, d, count_items, paths):
    """The `.yak` inputs, made on the card: phase 4's table (a.yak); the
    -b24 table (b24.yak), by the same-file shortcut's definition phase
    4's table shrunk to counts in [2, 1023], under bench.py's bloom
    gates; and the chrY, chrX and PAR tables counted at k=31."""
    from yak_tpu_torch.io.yakfmt import dump_yak
    from yak_tpu_torch.table import KmerTable

    paths["a"], paths["b24"] = (os.path.join(d, "a.yak"),
                                os.path.join(d, "b24.yak"))
    dump_yak(paths["a"], K, 10, *count_items)
    b24 = KmerTable(K, device=dev)
    b24._set_pairs(*count_items)
    b24.shrink(2, 1023)
    check_gates(b24, "the -b24 table (phase 4's, counts >= 2)",
                BLOOM_DISTINCT, BLOOM_HIST)
    with contextlib.redirect_stderr(io.StringIO()):
        b24.dump(paths["b24"])
    sexchr_tables(dev, d, paths)


def sexchr_tables(dev, d, paths):
    """The chrY, chrX and PAR tables counted at k=31 on the card, as
    `.yak` files beside their FASTAs (paths[name + ".yak"])."""
    from yak_tpu_torch.models.count import CountOpts, count_file

    with contextlib.redirect_stderr(io.StringIO()):
        for name in SEXCHR_REGIONS:
            paths[f"{name}.yak"] = os.path.join(d, f"{name}.yak")
            count_file(paths[name], CountOpts(k=K, chunk_size=1 << 23,
                                              device=str(dev))).dump(
                paths[f"{name}.yak"])


def timed_op(fn):
    """(fn's result, wall s, device span ms): CUDA events and the host
    clock around fn, synchronized."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    w0 = time.perf_counter()
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - w0, t0.elapsed_time(t1)


def check_joins(calls, label):
    """Kernel vs plain on every captured JOIN call; returns the max abs
    error."""
    err = 0
    for i, (args, _kw) in enumerate(calls):
        err = max(err, check_join(args, f"{label} JOIN {i}"))
    log(f"  {label}: kernel == plain on {len(calls)} captured JOIN calls")
    return err


def time_merge_call(call, label, card):
    """A kernels-line entry (time_merge) for one captured merge-reduce
    call, positional or keyword create, in its mode."""
    from yak_tpu_torch.ops import merge

    args, kw = call
    create = kw.get("create", args[4] if len(args) > 4 else True)
    ms, device_ms, plain_ms, plain_device_ms, bound = time_merge(
        merge, tuple(args[:4]) + (create,),
        {"wide": kw.get("wide", False), "weights": kw.get("weights")},
        f"{label} [{card}]")
    return {"max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "device_ms": device_ms, "plain_device_ms": plain_device_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None}


def check_sorts(calls, label):
    """Sort kernel vs plain (check_sort) on every captured sort call."""
    for i, (args, _kw) in enumerate(calls):
        check_sort((args[0], args[1] if len(args) > 1 else None),
                   f"{label} sort {i}")
    log(f"  {label}: kernel == plain on {len(calls)} captured sort calls, "
        f"inputs unchanged, pass counts as planned")


def check_merges(calls, label):
    """Kernel vs plain on every captured count-mode merge-reduce call
    (positional create, or the create= keyword); returns the max abs
    error."""
    from yak_tpu_torch.ops import merge

    err = 0
    for i, (args, kw) in enumerate(calls):
        create = kw.get("create", args[4] if len(args) > 4 else True)
        err = max(err, compare(merge, args[:4], create, f"{label} merge {i}",
                               wide=kw.get("wide", False)))
    return err


def membership_paths(dev, card, paths, results, by_path):
    """Phase 24, subtract and isec: phase 4's table restored on the card,
    filtered by the -b24 table: one JOIN of its 2^23 lanes with the
    identity as their lanes, then the compaction; counts and dump md5s
    gated.  The JOIN is checked against its plain version on the calls
    and timed at the call of subtract."""
    from yak_tpu_torch.ops import merge
    from yak_tpu_torch.table import KmerTable

    other = KmerTable.restore(paths["b24"], dev)
    for op, want in (("subtract", SUBTRACT_DISTINCT),
                     ("isec", ISEC_DISTINCT)):
        t = KmerTable.restore(paths["a"], dev)
        reset_counts()
        with captured("merge", "merge_join",
                      within="yak_tpu_torch.table") as js:
            _, wall, span = timed_op(lambda: getattr(t, op)(other))
        by_path[op] = read_counts()
        check_launched(by_path[op], ("merge_join",), op)
        out = os.path.join(os.path.dirname(paths["a"]), f"{op}.yak")
        with contextlib.redirect_stderr(io.StringIO()):
            t.dump(out)
        md5 = file_md5(out)
        log(f"  {op}: {t.tot} keys (want {want}), dump md5 {md5}; wall "
            f"{wall:.4f} s, device span {span:.4f} ms [{card}]")
        if t.tot != want:
            raise AssertionError(f"{op}: {t.tot} keys != {want}")
        check_digest(op, md5)
        r = results["merge_join"]
        r["max_abs_err"] = max(r["max_abs_err"], check_joins(js, op))
        if op == "subtract":
            args = js[0][0]
            live, nq = int(args[2]), args[3].numel()
            r.setdefault("shapes", {})["subtract"] = time_kernel(
                merge.merge_join, merge.merge_join_plain, args,
                (12 * live + 16 * nq) / HBM_BYTES_PER_S * 1e3, None,
                f"JOIN at subtract's call (cap {args[0].numel()}, live "
                f"{live}, {args[3].numel()} queries in their order)", card)
        del t


def recount_paths(dev, card, paths, chunks, results, by_path, psort=False):
    """Phase 24 (and 27 under psort), recount: phase 4's table restored,
    recounted over the reads it was counted from (the k=31 gates), and
    phase 11's k=33 table likewise (the k=33 gates); increment-only
    folds (count mode with create=False, the wide mode at k=33), each
    fold's split on the device timeline.  Every count-mode call, and
    under psort every sort call, is checked against its plain version."""
    from yak_tpu_torch.models.count import recount
    from yak_tpu_torch.table import KmerTable

    k33 = os.path.join(os.path.dirname(paths["a"]), "k33.yak")
    if not os.path.exists(k33):
        with contextlib.redirect_stderr(io.StringIO()):
            run_count(chunks, dev, k=K33).dump(k33)
    name = "psort recount" if psort else "recount"
    for label, src, total, digest, needed in (
            (name, paths["a"], TOTAL_GATE, HIST_GATE,
             ("sort_i64",) if psort else ("merge_reduce",)),
            (f"{name} k33", k33, K33_DISTINCT, K33_HIST,
             ("merge_reduce_wide",) + (("sort_i64",) if psort else ()))):
        t = KmerTable.restore(src, dev)
        reset_counts()
        with fold_timeline() as tl, captured("merge", "merge_reduce") as ms, \
                captured("sort", "sort") as ss:
            _, wall, _span = timed_op(lambda: recount(paths["reads"], t))
        by_path[label] = read_counts()
        check_gates(t, f"{label}: wall {wall:.4f} s [{card}]", total, digest)
        check_launched(by_path[label], needed, label)
        fold_split(tl.marks, wall, card, label)
        if any(c[0][4] for c in ms):
            raise AssertionError(f"{label} created keys")
        r = results["merge_reduce_wide" if "k33" in label else "merge_reduce"]
        r["max_abs_err"] = max(r["max_abs_err"], check_merges(ms, label))
        log(f"  {label}: kernel == plain on {len(ms)} captured merge calls")
        if psort:
            check_sorts(ss, label)
        if label == "recount":
            r.setdefault("shapes", {})["recount"] = time_merge_call(
                ms[0], "recount fold 0", card)
        del t, ms, ss


def cntasm_path(card, paths, results, by_path):
    """Phase 24, cntasm -c1 -x1 of the three assemblies through the CLI
    entry point on the card: each file counted, then folded in as
    presence votes (the count-mode merge of its keys counted once);
    the dump's md5 gated, the vote merges checked against their plain
    version."""
    from yak_tpu_torch import cli

    out = os.path.join(os.path.dirname(paths["a"]), "cntasm.yak")
    err = io.StringIO()
    reset_counts()
    with fold_timeline() as tl, \
            captured("merge", "merge_reduce", within="yak_tpu_torch.table") \
            as votes, contextlib.redirect_stderr(err):
        ret, wall, _span = timed_op(lambda: cli.main(
            ["cntasm", "-c1", "-x1", "-o", out, "--device", "cuda",
             *(paths[f"asm{i}"] for i in range(len(ASM_SUBS)))]))
    by_path["cntasm"] = read_counts()
    if ret != 0:
        raise AssertionError(f"cntasm failed: {err.getvalue()[-2000:]}")
    log("  " + " / ".join(r for r in err.getvalue().splitlines()
                          if r.startswith("[M::cntasm]")))
    md5 = file_md5(out)
    log(f"  cntasm -c1 -x1 of {len(ASM_SUBS)} assemblies: dump md5 {md5}; "
        f"wall {wall:.4f} s [{card}]")
    check_digest("cntasm", md5)
    check_launched(by_path["cntasm"], ("merge_reduce",), "cntasm")
    fold_split(tl.marks, wall, card, "cntasm (its count folds)")
    if len(votes) != len(ASM_SUBS) - 1:
        raise AssertionError(f"cntasm: {len(votes)} vote merges")
    r = results["merge_reduce"]
    r["max_abs_err"] = max(r["max_abs_err"], check_merges(votes, "cntasm"))
    r.setdefault("shapes", {})["cntasm_vote"] = time_merge_call(
        votes[-1], "cntasm presence vote 1", card)


def print_path(card, paths):
    """Phase 24, print -c of phase 4's table through the CLI entry point
    (host work: the hashes inverted, the lines built a block at a
    time): its lines and md5 gated."""
    from yak_tpu_torch import cli

    sink = _Digest()
    with contextlib.redirect_stdout(sink), \
            contextlib.redirect_stderr(io.StringIO()):
        ret, wall, _span = timed_op(lambda: cli.main(
            ["print", "-c", paths["a"], "--device", "cuda"]))
    log(f"  print -c: {sink.lines} lines, md5 {sink.digest()}; wall "
        f"{wall:.4f} s [{card}]")
    if ret != 0 or sink.lines != TOTAL_GATE:
        raise AssertionError(f"print -c: exit {ret}, {sink.lines} lines")
    check_digest("print", sink.digest())


def inspect_path(dev, card, paths, results, by_path, psort=False):
    """Phase 25 (and 27 under psort): inspect of phase 4's table alone
    (host), then against the -b24 table on the card, the first streamed
    in two 2^22-key batches, each sorted and JOINed (under psort the
    query sort through the sort kernel); md5s gated, the per-batch split
    on the device timeline, the JOIN calls (and under psort the sort
    calls) checked."""
    from yak_tpu_torch import table as table_mod
    from yak_tpu_torch.models.inspect import main_inspect

    if not psort:
        sink = _Digest()
        _, wall, _span = timed_op(lambda: main_inspect(paths["a"], None,
                                                       out=sink))
        log(f"  inspect a.yak: {sink.lines} lines, md5 {sink.digest()}; "
            f"wall {wall:.4f} s (host)")
        check_digest("inspect", sink.digest())
    name = "psort inspect" if psort else "inspect"
    sink = _Digest()
    tl = _LookupTimeline(table_mod.countstep)
    table_mod.countstep = tl
    reset_counts()
    try:
        # qv_solve's warnings (low coverage) go to stderr, as in yak_tpu
        with captured("merge", "merge_join") as js, \
                captured("sort", "sort") as ss, \
                contextlib.redirect_stderr(io.StringIO()):
            _, wall, _span = timed_op(lambda: main_inspect(
                paths["a"], paths["b24"], out=sink, device=dev))
    finally:
        table_mod.countstep = tl.countstep
    by_path[name] = read_counts()
    log(f"  {name} a.yak b24.yak: {sink.lines} lines, md5 "
        f"{sink.digest()}; wall {wall:.4f} s [{card}]")
    check_digest("inspect2", sink.digest())
    check_launched(by_path[name], ("merge_join",) + (
        ("sort_i64_i32",) if psort else ()), name)
    busy, _ = split_chunks(tl.marks, card)
    log(f"  {name}: device busy {busy:.4f} ms of {wall * 1e3:.4f} ms wall, "
        f"idle {1 - busy / (wall * 1e3):.4f} [{card}]")
    if len(js) != 2:
        raise AssertionError(f"{name}: {len(js)} JOINs, want 2 batches")
    r = results["merge_join"]
    r["max_abs_err"] = max(r["max_abs_err"], check_joins(js, name))
    if psort:
        check_sorts(ss, name)


def sexchr_path(dev, card, paths, results, by_path, psort=False):
    """Phase 26 (and 27 under psort): the chrY, chrX and PAR tables
    loaded as bits 1, 2, 4, then sexchr of hap1 and hap2 (six 2^23-base
    chunks each) and groupxy of its output; both md5s gated, the
    per-chunk split on the device timeline, every JOIN call (and under
    psort every sort call) checked."""
    from yak_tpu_torch.models import scan, sexchr

    ch, wall, _span = timed_op(lambda: sexchr.load_sexchr_tables(
        *(paths[f"{n}.yak"] for n in SEXCHR_REGIONS), dev))
    log(f"  load_sexchr_tables: {ch.tot} keys in {wall:.4f} s [{card}]")
    name = "psort sexchr" if psort else "sexchr"
    buf = io.StringIO()
    tl = _LookupTimeline(scan.countstep)
    scan.countstep = tl
    reset_counts()
    try:
        with captured("merge", "merge_join") as js, \
                captured("sort", "sort") as ss:
            _, wall, _span = timed_op(lambda: sexchr.main_sexchr(
                sexchr.SexchrOpts(), ch, [paths["hap1"], paths["hap2"]],
                out=buf))
    finally:
        scan.countstep = tl.countstep
    by_path[name] = read_counts()
    text = buf.getvalue()
    md5 = hashlib.md5(text.encode()).hexdigest()[:12]
    npos = 2 * TRIO_CONTIGS * (GENOME_LEN - N_CONTIGS * (K - 1))
    log(f"  {name}: {text.count(chr(10))} lines, md5 {md5}; wall "
        f"{wall:.4f} s, {npos / wall:.1f} positions/s [{card}]")
    check_digest("sexchr", md5)
    check_launched(by_path[name], ("merge_join",) + (
        ("sort_i64_i32",) if psort else ()), name)
    busy, _ = split_chunks(tl.marks, card)
    log(f"  {name}: device busy {busy:.4f} ms of {wall * 1e3:.4f} ms wall, "
        f"idle {1 - busy / (wall * 1e3):.4f} [{card}]")
    r = results["merge_join"]
    r["max_abs_err"] = max(r["max_abs_err"], check_joins(js, name))
    if psort:
        check_sorts(ss, name)
    else:
        lines = sexchr.groupxy(io.StringIO(text))
        gx = hashlib.md5("".join(f"{x}\n" for x in lines).encode())
        log(f"  groupxy: {len(lines)} rows, md5 {gx.hexdigest()[:12]}, "
            f"column 4 " + ", ".join(
                f"{v}: {sum(x.split(chr(9))[3] == v for x in lines)}"
                for v in ("1", "2")))
        check_digest("groupxy", gx.hexdigest()[:12])


def algebra_cli_check():
    """Phase 28: recount, cntasm, subtract, isec, print -c, inspect (one
    and two tables), sexchr and groupxy through the CLI entry point on
    the card and on the CPU, chunk 16384, on phase 5's inputs (tables
    counted on the card from the FASTQ and the FASTA): byte-identical
    stdout and dumps."""
    from yak_tpu_torch import cli

    d = tempfile.mkdtemp(prefix="yak_tpu_torch_smoke_")
    try:
        fq, fa = write_inputs(d)
        A, B = os.path.join(d, "a.yak"), os.path.join(d, "b.yak")
        with contextlib.redirect_stderr(io.StringIO()):
            for out, src in ((A, fq), (B, fa)):
                if cli.main(["count", "-K16384", "--device", "cuda", "-o",
                             out, src]) != 0:
                    raise AssertionError("CLI count failed")
        sx = os.path.join(d, "sexchr.txt")
        for cmd in (["recount", "-o", "@", A, fa],
                    ["cntasm", "-K16384", "-o", "@", fa, fq],
                    ["subtract", "-o", "@", A, B], ["isec", "-o", "@", A, B],
                    ["print", "-c", B], ["inspect", A], ["inspect", A, B],
                    ["sexchr", "-K16384", A, B, A, fa, fq], ["groupxy", sx]):
            outs = {}
            for devname in ("cuda", "cpu"):
                dump = os.path.join(d, f"out.{devname}.yak")
                buf, err = io.StringIO(), io.StringIO()
                with contextlib.redirect_stdout(buf), \
                        contextlib.redirect_stderr(err):
                    ret = cli.main([dump if a == "@" else a for a in cmd]
                                   + ["--device", devname])
                if ret != 0:
                    raise AssertionError(f"CLI {cmd[0]} failed on {devname}:"
                                         f" {err.getvalue()[-2000:]}")
                raw = b""
                if "@" in cmd:
                    with open(dump, "rb") as f:
                        raw = f.read()
                outs[devname] = buf.getvalue().encode() + raw
            name = " ".join(os.path.basename(a) for a in cmd)
            if outs["cuda"] != outs["cpu"] or not outs["cuda"]:
                raise AssertionError(f"{name}: CUDA and CPU outputs differ")
            if cmd[0] == "sexchr":
                with open(sx, "wb") as f:
                    f.write(outs["cuda"])
            log(f"  {name}: CUDA and CPU outputs identical "
                f"({len(outs['cuda'])} bytes, md5 "
                f"{hashlib.md5(outs['cuda']).hexdigest()[:12]})")
    finally:
        for name in os.listdir(d):
            os.unlink(os.path.join(d, name))
        os.rmdir(d)


def algebra_phases(dev, card, count_items, reads, chunks, results, by_path):
    """Phases 24-28."""
    genome = np.random.default_rng(42).integers(0, 4, GENOME_LEN,
                                                dtype=np.uint8)
    d = tempfile.mkdtemp(prefix="yak_tpu_torch_algebra_")
    try:
        t0 = time.perf_counter()
        paths = algebra_files(d, genome, reads)
        algebra_tables(dev, d, count_items, paths)
        log(f"  algebra inputs and tables made in "
            f"{time.perf_counter() - t0:.3f} s")

        phase("24. table algebra and print at real size")
        membership_paths(dev, card, paths, results, by_path)
        recount_paths(dev, card, paths, chunks, results, by_path)
        cntasm_path(card, paths, results, by_path)
        print_path(card, paths)

        phase("25. inspect at real size")
        inspect_path(dev, card, paths, results, by_path)

        phase("26. sexchr and groupxy at real size")
        sexchr_path(dev, card, paths, results, by_path)

        phase("27. the psort engine on recount, inspect and sexchr")
        with psort_engine():
            recount_paths(dev, card, paths, chunks, results, by_path,
                          psort=True)
            inspect_path(dev, card, paths, results, by_path, psort=True)
            sexchr_path(dev, card, paths, results, by_path, psort=True)
    finally:
        for name in os.listdir(d):
            os.unlink(os.path.join(d, name))
        os.rmdir(d)

    phase("28. the algebra, print, inspect, sexchr and groupxy CLI on the "
          "card vs on the CPU")
    algebra_cli_check()


# -- phases 29-30: counting and qv on a mesh of 4 shards of the card -------

# the port's mesh launches by kernels-line entry: a per-shard launch of a
# kernel that yak_tpu launches through a shard_map wrapper
MESH_ENTRIES = {"merge_reduce": "merge_reduce_mesh",
                "merge_reduce_weighted": "merge_reduce_weighted_mesh",
                "merge_reduce_wide": "merge_reduce_wide_mesh",
                "merge_join": "merge_join_mesh",
                "compact": "compact_mesh",
                "sort_i64": "sort_i64_mesh",
                "sort_i64_i32": "sort_i64_i32_mesh"}
_MESH_SORT = {"replaces": "yak_tpu/ops/pallas_sort.py:691",
              "replaces_also": ["yak_tpu/ops/pallas_sort.py:631",
                                "yak_tpu/ops/pallas_sort.py:717"]}
KERNELS.update({
    "merge_reduce_mesh": dict(KERNELS["merge_reduce"],
                              name="merge_reduce_mesh",
                              replaces="yak_tpu/ops/pallas_merge.py:605"),
    "merge_reduce_wide_mesh": dict(KERNELS["merge_reduce_wide"],
                                   name="merge_reduce_wide_mesh",
                                   replaces="yak_tpu/ops/pallas_merge.py:605"),
    # the gated pass-1 fold of a shard (phase 33): the weighted mode in
    # place of yak_tpu's shard_mapped count step with its bloom_cfg
    "merge_reduce_weighted_mesh": dict(
        KERNELS["merge_reduce_weighted"], name="merge_reduce_weighted_mesh",
        replaces="yak_tpu/ops/pallas_merge.py:336",
        replaces_also=["yak_tpu/parallel/mesh.py:338"]),
    # a shard's sentinel gate post (phase 33) and the chunk posts' markers
    # on the mesh (phase 34), in place of build_count_step / the lookup
    # steps' shard_mapped reductions
    "compact_mesh": dict(KERNELS["compact"], name="compact_mesh",
                         replaces_also=["yak_tpu/parallel/mesh.py:338",
                                        "yak_tpu/parallel/mesh.py:429",
                                        "yak_tpu/parallel/mesh.py:653"]),
    # sort_planes32_mesh's two order restores are the JOIN's stores at the
    # lane and the scatter by slot (parallel/mesh._route_back)
    "merge_join_mesh": dict(KERNELS["merge_join"], name="merge_join_mesh",
                            replaces="yak_tpu/ops/pallas_merge.py:605",
                            replaces_also=["yak_tpu/ops/pallas_sort.py:701"]),
    "sort_i64_mesh": dict(KERNELS["sort_i64"], name="sort_i64_mesh",
                          **_MESH_SORT),
    "sort_i64_i32_mesh": dict(KERNELS["sort_i64_i32"],
                              name="sort_i64_i32_mesh", **_MESH_SORT),
})


def mesh_counts(counts):
    """read_counts() of a mesh path under the mesh entries' names."""
    return {MESH_ENTRIES.get(n, n): c for n, c in counts.items()}


class _GroupMarks:
    """Marks each group's phases (the hook of count_file_mesh and
    mesh_routed_groups) and, standing in for ops.countstep inside
    models.qv, each chunk's post, with a CUDA event and the host
    clock."""

    def __init__(self, countstep=None):
        self.countstep, self.marks = countstep, []

    def __getattr__(self, attr):
        return getattr(self.countstep, attr)

    def __call__(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev, time.perf_counter()))

    def qv_join_post(self, *args, **kw):
        out = self.countstep.qv_join_post(*args, **kw)
        self("post")
        return out


def split_groups(marks, wall, card, what):
    """Per-group device spans (CUDA events) and host spans of one marked
    mesh run, the routing per group, and the device busy and idle share
    of the wall, the "h2d" spans (the host packing the group's chunks,
    each upload waiting for it) left out of busy; returns the device
    busy ms."""
    groups, cur = [], None
    for m in marks:
        if m[0] == "start":
            cur = [m]
            groups.append(cur)
        else:
            cur.append(m)
    busy, by_phase, route_host = 0.0, {}, []
    for i, g in enumerate(groups):
        dev = [(b[0], a[1].elapsed_time(b[1])) for a, b in zip(g, g[1:])]
        host = [(b[0], (b[2] - a[2]) * 1e3) for a, b in zip(g, g[1:])]
        busy += sum(ms for n, ms in dev if n != "h2d")
        for n, ms in dev:
            by_phase.setdefault(n, []).append(ms)
        route_host += [ms for n, ms in host if n == "route"]
        log(f"  {what} group {i} device: " + ", ".join(
            f"{n} {ms:.4f} ms" for n, ms in dev) + f" [{card}]")
        log(f"  {what} group {i} host:   " + ", ".join(
            f"{n} {ms:.4f} ms" for n, ms in host))
    route = by_phase.get("route", [0.0])
    log(f"  {what}: {len(groups)} groups of {MESH_SHARDS} chunks; routing "
        f"per group {min(route):.4f}-{max(route):.4f} ms on the device, "
        f"{min(route_host):.4f}-{max(route_host):.4f} ms on the host (its "
        f"one read of the counts included); device busy {busy:.4f} ms of "
        f"{wall * 1e3:.4f} ms wall, idle {1 - busy / (wall * 1e3):.4f} "
        f"[{card}]")
    return busy


def beside(what, wall, busy, one, card):
    """The mesh run's wall and busy time beside the one-device phase's."""
    w1, b1 = ONE_DEVICE[one]
    log(f"  {what}: wall {wall:.4f} s, device busy {busy:.4f} ms on "
        f"{MESH_SHARDS} shards of the card; {one} on one device (phase "
        f"{4 if one == 'count' else 7}): wall {w1:.4f} s, busy {b1:.4f} ms "
        f"[{card}]")


def mesh_count_paths(dev, card, fa, count_items, chunks, results, by_path):
    """Phase 29; returns the k=31 mesh table."""
    from yak_tpu_torch.io import yakfmt
    from yak_tpu_torch.models.count import CountOpts
    from yak_tpu_torch.ops import sort
    from yak_tpu_torch.parallel.mesh import count_file_mesh, make_mesh

    mesh = make_mesh(devices=[dev] * MESH_SHARDS)
    d = os.path.dirname(fa)
    one = {K: os.path.join(d, "one.yak"), K33: os.path.join(d, "one33.yak")}
    yakfmt.dump_yak(one[K], K, 10, *count_items)
    with contextlib.redirect_stderr(io.StringIO()):
        run_count(chunks, dev, k=K33).dump(one[K33])
    for k in one:
        log(f"  one-device k={k} dump md5 {file_md5(one[k])}")
    ONE_DUMP_MD5["k31"] = file_md5(one[K])

    def count(k, cap_log2, marks):
        opt = CountOpts(k=k, chunk_size=MESH_CHUNK, device=str(dev))
        t0 = time.perf_counter()
        mt = count_file_mesh(fa, opt, mesh, cap_log2=cap_log2, hook=marks)
        torch.cuda.synchronize()
        return mt, time.perf_counter() - t0

    table, err, default_items = None, {}, {}
    for name, k, total, digest, psort, cap_log2 in (
            ("mesh count", K, TOTAL_GATE, HIST_GATE, False, MESH_CAP_LOG2),
            ("mesh k33", K33, K33_DISTINCT, K33_HIST, False, MESH_CAP_LOG2),
            ("psort mesh count, replayed", K, TOTAL_GATE, HIST_GATE, True,
             MESH_REPLAY_CAP_LOG2),
            ("psort mesh k33", K33, K33_DISTINCT, K33_HIST, True,
             MESH_CAP_LOG2)):
        merge_entry = "merge_reduce_wide" if k == K33 else "merge_reduce"
        with psort_engine() if psort else contextlib.nullcontext():
            marks = _GroupMarks()
            reset_counts()
            with captured("merge", "merge_reduce") as ms, \
                    captured("sort", "sort") as ss:
                mt, wall = count(k, cap_log2, marks)
            counts = read_counts()
        by_path[name] = mesh_counts(counts)
        check_gates(mt, f"{name}: wall {wall:.4f} s [{card}]", total, digest)
        check_launched(counts, (merge_entry,) + (("sort_i64",) if psort
                                                 else ()), name)
        items = mt.items()
        if not psort:
            # the dump, as one-device dumps are, md5-equal to phase 4's
            # (phase 11's count at k=33)
            out = os.path.join(d, "mesh.yak")
            with contextlib.redirect_stderr(io.StringIO()):
                mt.dump(out)
            if file_md5(out) != file_md5(one[k]):
                raise AssertionError(f"{name}: the dump differs from the "
                                     f"one-device dump")
            log(f"  {name}: dump md5 {file_md5(out)} = the one-device "
                f"dump's")
            default_items[k] = items
        elif not all(np.array_equal(a, b)
                     for a, b in zip(items, default_items[k])):
            # the same items shard by shard: the same dump
            raise AssertionError(f"{name}: items differ from the default "
                                 f"engine's")
        else:
            log(f"  {name}: items equal to the default engine's, shard by "
                f"shard (the same dump)")
        log(f"  {name}: shard sizes {[s.tot for s in mt.shards]}, "
            f"capacities {[s.cap for s in mt.shards]}")
        if cap_log2 == MESH_REPLAY_CAP_LOG2:
            if not all(s.cap > 1 << cap_log2 for s in mt.shards):
                raise AssertionError(f"{name}: no shard grew from 2^"
                                     f"{cap_log2} lanes")
            log(f"  {name}: every shard grew from 2^{cap_log2} lanes by the "
                f"one-fold-late replay ({len(ms)} merge calls for "
                f"{sum(m[0] == 'start' for m in marks.marks)} groups of "
                f"{MESH_SHARDS} shards)")
        busy = split_groups(marks.marks, wall, card, name)
        if not psort and k == K:
            beside(name, wall, busy, "count", card)
            ONE_DEVICE[name] = (wall, busy)     # beside phase 35's
        mesh_entry = MESH_ENTRIES[merge_entry]
        err[mesh_entry] = max(err.get(mesh_entry, 0), check_merges(ms, name))
        log(f"  {name}: kernel == plain on {len(ms)} captured per-shard "
            f"merge calls")
        if psort:
            check_sorts(ss, name)
        if not psort and mesh_entry not in results:
            results[mesh_entry] = time_merge_call(
                ms[-1], f"{name}: the last shard's fold of the last group",
                card)
        if psort and k == K33:
            keys = max((a[0] for a, _kw in ss), key=lambda t: t.numel())
            results["sort_i64_mesh"] = time_kernel(
                sort.sort, sort.sort_plain, (keys, None),
                2 * keys.numel() * 8 / HBM_BYTES_PER_S * 1e3,
                lambda keys=keys: torch.sort(keys),
                f"sort_i64 at {name}'s largest shard batch (n "
                f"{keys.numel()}; library: torch.sort)", card)
        if name == "mesh count":
            table = mt
        del mt, ms, ss, items
    for entry, e in err.items():
        results[entry]["max_abs_err"] = max(results[entry]["max_abs_err"], e)
    results["sort_i64_mesh"]["max_abs_err"] = 0    # check_sorts raised else
    return table


def mesh_qv_paths(dev, card, table, paths, results, by_path):
    """Phase 30: qv of seeds 101 and 102 against phase 29's table on both
    engines, through the routed lookup; the gates, and every per-shard
    JOIN and sort call checked against its plain version."""
    from yak_tpu_torch.models import qv
    from yak_tpu_torch.ops import merge, sort
    from yak_tpu_torch.parallel import mesh as pmesh

    n_lookups = N_READS * (READ_LEN - K + 1)
    route = pmesh.mesh_routed_groups
    join_err = 0
    for psort in (False, True):
        for seed in QV_SEEDS:
            name = f"{'psort ' if psort else ''}mesh qv {seed}"
            marks = _GroupMarks(qv.countstep)
            qv.countstep = marks
            qv.mesh_routed_groups = lambda *a, **kw: route(*a, hook=marks,
                                                           **kw)
            try:
                with psort_engine() if psort else contextlib.nullcontext():
                    reset_counts()
                    with captured("merge", "merge_join") as js, \
                            captured("sort", "sort") as ss:
                        t0 = time.perf_counter()
                        cnt = qv.run_qv(qv_opts(), paths[seed], table,
                                        out=io.StringIO())
                        torch.cuda.synchronize()
                        wall = time.perf_counter() - t0
                    counts = read_counts()
            finally:
                qv.countstep = marks.countstep
                qv.mesh_routed_groups = route
            by_path[name] = mesh_counts(counts)
            check_launched(counts, ("merge_join",) + (
                ("sort_i64_i32", "sort_i32") if psort else ()), name)
            dg = hashlib.md5(np.ascontiguousarray(cnt, np.int64)
                             .tobytes()).hexdigest()[:12]
            log(f"  {name}: cnt sum {int(cnt.sum())}, cnt[0] {int(cnt[0])}, "
                f"digest {dg}; {n_lookups / wall:.1f} lookups/s [{card}]")
            if (int(cnt.sum()) != QV_SUM or int(cnt[0]) != 0
                    or dg != QV_SEEDS[seed]):
                raise AssertionError(f"{name}: gates failed")
            busy = split_groups(marks.marks, wall, card, name)
            if not psort:
                beside(name, wall, busy, f"qv {seed}", card)
            join_err = max(join_err, check_joins(js, name))
            if psort:
                check_sorts(ss, name)
            if not psort and "merge_join_mesh" not in results:
                args = js[0][0]
                live, nq = int(args[2]), args[3].numel()
                results["merge_join_mesh"] = time_kernel(
                    merge.merge_join, merge.merge_join_plain, args,
                    (12 * live + 16 * nq) / HBM_BYTES_PER_S * 1e3, None,
                    f"JOIN at shard 0's queries of group 0 (cap "
                    f"{args[0].numel()}, live {live}, B {nq})", card)
            if psort and "sort_i64_i32_mesh" not in results:
                keys, pay = max(((a[0], a[1]) for a, _kw in ss
                                 if len(a) > 1 and a[0].dtype == torch.int64),
                                key=lambda t: t[0].numel())
                results["sort_i64_i32_mesh"] = time_kernel(
                    sort.sort, sort.sort_plain, (keys, pay),
                    2 * keys.numel() * 12 / HBM_BYTES_PER_S * 1e3,
                    lambda keys=keys: torch.sort(keys),
                    f"sort_i64_i32 at {name}'s largest shard batch (n "
                    f"{keys.numel()}; library: torch.sort of the keys)",
                    card)
                results["sort_i64_i32_mesh"]["max_abs_err"] = 0
            del js, ss
    results["merge_join_mesh"]["max_abs_err"] = join_err


def mesh_phases(dev, card, count_items, reads, chunks, results, by_path):
    """Phases 29-30."""
    d = tempfile.mkdtemp(prefix="yak_tpu_torch_mesh_")
    try:
        t0 = time.perf_counter()
        fa = os.path.join(d, "reads.fa")
        write_fasta(fa, reads)
        paths = write_qv_sets(d, QV_SEEDS)
        log(f"  mesh inputs written in {time.perf_counter() - t0:.3f} s")

        phase(f"29. count on a mesh of {MESH_SHARDS} shards of the card")
        table = mesh_count_paths(dev, card, fa, count_items, chunks, results,
                                 by_path)

        phase(f"30. qv on a mesh of {MESH_SHARDS} shards of the card")
        mesh_qv_paths(dev, card, table, paths, results, by_path)
    finally:
        for name in os.listdir(d):
            os.unlink(os.path.join(d, name))
        os.rmdir(d)

# -- phases 31-32: the native reader and -X at real size -------------------

# the -X configurations of phase 32 (count flags, input files) and the md5
# of each dump, as `yak_tpu` writes it on the CPU for the same seeded
# inputs (tools/exact_gates.py)
EXACT_CONFIGS = {"k31": (["-k31"], ("reads",)),
                 "b24": (["-k31", "-b24"], ("reads", "qv101")),
                 "k33": (["-k33"], ("reads",))}
EXACT_DIGEST = {"k31": "e7234707ce7b", "b24": "be368a48d47b",
                "k33": "c3ed10119581"}


def exact_files(d, reads):
    """The inputs of phase 32 (numpy only; also what tools/exact_gates.py
    gives `yak_tpu`): phase 4's reads as phase 10's one-line FASTA, and
    bench.py's seed-101 qv read set (400,000 error-free reads of the
    genome), pass 2 of the -b24 configuration."""
    paths = {"reads": os.path.join(d, "reads.fa")}
    write_fasta(paths["reads"], reads)
    paths["qv101"] = write_qv_sets(d, (101,))[101]
    return paths


@contextlib.contextmanager
def reader_spy(module, force_python=False):
    """Inside the block, `module`'s ChunkSource records the reader each
    source took and the host seconds its consumer spent inside the
    source's iterator (for the Python reader the parse and the packing,
    for the native one the wait for its parser thread and the copies
    out of its buffers); force_python: every source takes the Python
    reader.  Yields {"readers": [...], "secs": s, "chunks": n}."""
    from yak_tpu_torch.io.chunks import ChunkSource

    rec = {"readers": [], "secs": 0.0, "chunks": 0}

    class Spy(ChunkSource):
        def __init__(self, *args, **kw):
            if force_python:
                kw["force_python"] = True
            super().__init__(*args, **kw)
            rec["readers"].append(self.reader)

        def __iter__(self):
            it = super().__iter__()
            while True:
                t0 = time.perf_counter()
                try:
                    packed = next(it)
                except StopIteration:
                    rec["secs"] += time.perf_counter() - t0
                    return
                rec["secs"] += time.perf_counter() - t0
                rec["chunks"] += 1
                yield packed

    real = module.ChunkSource
    module.ChunkSource = Spy
    try:
        yield rec
    finally:
        module.ChunkSource = real


def check_mode_merges(calls, label, results):
    """Kernel vs plain on every captured merge-reduce call, each in its
    mode (count, weighted or wide), into the kernels line's errors."""
    from yak_tpu_torch.ops import merge

    for i, (args, kw) in enumerate(calls):
        create = kw.get("create", args[4] if len(args) > 4 else True)
        r = results[merge_mode(kw)]
        r["max_abs_err"] = max(r["max_abs_err"], compare(
            merge, args[:4], create, f"{label} merge {i}",
            weights=kw.get("weights"), wide=kw.get("wide", False)))
    log(f"  {label}: kernel == plain on {len(calls)} captured merge calls")


def reader_paths(dev, card, d, paths, reads, results, by_path):
    """Phase 31: phase 4's reads as FASTQ, gzip FASTQ and phase 10's
    one-line FASTA, each counted by models.count.count through the native
    reader (phase 4's gates; every merge call held against its plain
    version), the FASTA and the FASTQ again through the Python reader;
    then qv seed 101 through the native reader against the native FASTA
    count's table.  Prints, reader beside reader, the wall, the host
    time inside the reader and the device's busy and idle shares."""
    import gzip

    from yak_tpu_torch.models import count as count_mod
    from yak_tpu_torch.models import qv as qv_mod

    paths = {"fasta": paths["reads"], 101: paths["qv101"],
             "fastq": os.path.join(d, "reads.fq")}
    write_fastq(paths["fastq"], reads)
    paths["fastq.gz"] = paths["fastq"] + ".gz"
    with open(paths["fastq"], "rb") as f, \
            gzip.open(paths["fastq.gz"], "wb", compresslevel=1) as g:
        g.write(f.read())
    n_kmers = N_READS * (READ_LEN - K + 1)
    walls, table = {}, None
    for reader, fmt in (("native", "fastq"), ("native", "fastq.gz"),
                        ("native", "fasta"), ("python", "fasta"),
                        ("python", "fastq")):
        label = f"{reader} reader {fmt}"
        reset_counts()
        with fold_timeline() as tl, \
                captured("merge", "merge_reduce") as ms, \
                reader_spy(count_mod, reader == "python") as rec:
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(io.StringIO()):
                t = count_mod.count([paths[fmt]], count_mod.CountOpts(
                    k=K, chunk_size=1 << 23, device=str(dev)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_path[label] = read_counts()
        if rec["readers"] != [reader]:
            raise AssertionError(f"{label}: ChunkSource took "
                                 f"{rec['readers']}")
        check_gates(t, label)
        check_launched(by_path[label], ("merge_reduce",), label)
        busy = fold_split(tl.marks, wall, card, label)
        check_mode_merges(ms, label, results)
        walls[label] = (wall, rec["secs"], busy)
        log(f"  {label}: wall {wall:.4f} s ({n_kmers / wall:.1f} k-mers/s), "
            f"{rec['secs']:.4f} s of it inside the reader over "
            f"{rec['chunks']} chunks; device busy {busy:.4f} ms, idle "
            f"{1 - busy / (wall * 1e3):.4f} [{card}]")
        if label == "native reader fasta":
            table = t
        del t, ms
    for fmt in ("fasta", "fastq"):
        (nw, ns, nb), (pw, ps, pb) = (walls[f"{r} reader {fmt}"]
                                      for r in ("native", "python"))
        log(f"  {fmt}: native reader wall {nw:.4f} s (reader {ns:.4f} s, "
            f"idle {1 - nb / (nw * 1e3):.4f}) against the Python reader's "
            f"{pw:.4f} s (reader {ps:.4f} s, idle "
            f"{1 - pb / (pw * 1e3):.4f}) [{card}]")
    reset_counts()
    with reader_spy(qv_mod) as rec:
        qv_run(table, paths, 101, card)
    by_path["native reader qv"] = read_counts()
    check_launched(by_path["native reader qv"], ("merge_join",),
                   "native reader qv")
    if rec["readers"] != ["native"]:
        raise AssertionError(f"qv: ChunkSource took {rec['readers']}")
    log(f"  qv seed 101 through the native reader: {rec['secs']:.4f} s "
        f"inside the reader over {rec['chunks']} chunks")


@contextlib.contextmanager
def timed_exact_dump():
    """Inside the block, `-X`'s dump (the khashl replay, the cross-check
    and the write) appends its seconds to the list yielded."""
    from yak_tpu_torch.io import exactdump

    real_dump, dump_s = exactdump.dump_yak_exact, []

    def timed_dump(*args, **kw):
        t0 = time.perf_counter()
        real_dump(*args, **kw)
        dump_s.append(time.perf_counter() - t0)

    exactdump.dump_yak_exact = timed_dump
    try:
        yield dump_s
    finally:
        exactdump.dump_yak_exact = real_dump


def exact_paths(card, d, paths, results, by_path):
    """Phase 32: `count -X` through the CLI in this process on the card,
    for each of EXACT_CONFIGS (k=31; -b24 over the reads and then the
    seed-101 reads, two different files, pass 1 through the serial-exact
    gate; k=33): the dump's built-in cross-check against the table must
    pass and its md5 must be EXACT_DIGEST's; every captured count,
    weighted and wide merge call is held against its plain version.
    Then -X -b37 must be refused (exit 1, yak_tpu's message: its packed
    rank key would not fit) and -X -b24 under psort must raise."""
    from yak_tpu_torch import cli

    needed = {"k31": ("merge_reduce",),
              "b24": ("merge_reduce_weighted", "merge_reduce"),
              "k33": ("merge_reduce_wide",)}
    for name, (flags, files) in EXACT_CONFIGS.items():
        label = f"-X {name}"
        out = os.path.join(d, f"x_{name}.yak")
        reset_counts()
        with timed_exact_dump() as dump_s, fold_timeline() as tl, \
                captured("merge", "merge_reduce") as ms, \
                contextlib.redirect_stderr(io.StringIO()) as err:
            t0 = time.perf_counter()
            rc = cli.main(["count", "-X", *flags, "--device", "cuda",
                           "-o", out, *(paths[f] for f in files)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"{label}: exit {rc}: "
                                 f"{err.getvalue()[-2000:]}")
        by_path[label] = read_counts()
        md5 = file_md5(out)
        log(f"  {label} ({' '.join(flags)} of {', '.join(files)}): dump md5 "
            f"{md5} (want {EXACT_DIGEST[name]}), cross-check passed; wall "
            f"{wall:.4f} s, of it the replay, cross-check and dump "
            f"{dump_s[0]:.4f} s [{card}]")
        EXACT_WALLS[name] = (wall, dump_s[0])
        if md5 != EXACT_DIGEST[name]:
            raise AssertionError(f"{label}: md5 {md5} != "
                                 f"{EXACT_DIGEST[name]}")
        check_launched(by_path[label], needed[name], label)
        fold_split(tl.marks, wall - dump_s[0], card, label)
        check_mode_merges(ms, label, results)
        os.unlink(out)
        del ms
    out = os.path.join(d, "x_b37.yak")
    with contextlib.redirect_stderr(io.StringIO()) as err:
        rc = cli.main(["count", "-X", "-k31", "-b37", "--device", "cuda",
                       "-o", out, paths["reads"], paths["qv101"]])
    if rc != 1 or "cannot engage the serial-exact Bloom gate" not in \
            err.getvalue() or os.path.exists(out):
        raise AssertionError(f"-X -b37 was not refused: exit {rc}, "
                             f"{err.getvalue()[-2000:]}")
    log("  -X -b37: refused, exit 1: " + next(
        line for line in err.getvalue().splitlines() if "ERROR" in line))
    torch.cuda.empty_cache()
    try:
        with psort_engine(), contextlib.redirect_stderr(io.StringIO()):
            cli.main(["count", "-X", "-k31", "-b24", "--device", "cuda",
                      "-o", out, paths["reads"], paths["qv101"]])
    except RuntimeError as e:
        log(f"  -X -b24 under psort: refused: {e}")
    else:
        raise AssertionError("-X -b24 under YAK_TPU_PSORT=1 was not "
                             "refused")


def native_phases(dev, card, reads, results, by_path):
    """Phases 31-32."""
    d = tempfile.mkdtemp(prefix="yak_tpu_torch_native_")
    try:
        t0 = time.perf_counter()
        paths = exact_files(d, reads)
        log(f"  inputs written in {time.perf_counter() - t0:.3f} s")
        phase("31. the native reader at real size")
        reader_paths(dev, card, d, paths, reads, results, by_path)
        phase("32. -X (the byte-exact dump) at real size")
        exact_paths(card, d, paths, results, by_path)
    finally:
        for name in os.listdir(d):
            os.unlink(os.path.join(d, name))
        os.rmdir(d)


# -- phases 33-34: -b, chkerr, triobin, trioeval and sexchr on the mesh ----

def mesh_kernel_checks(ms, cs, label, results):
    """Every captured merge-reduce call (in its mode) and compaction call
    of a mesh path held against its plain version, into the mesh
    entries' errors."""
    from yak_tpu_torch.ops import merge

    for i, (args, kw) in enumerate(ms):
        create = kw.get("create", args[4] if len(args) > 4 else True)
        r = results[MESH_ENTRIES[merge_mode(kw)]]
        r["max_abs_err"] = max(r["max_abs_err"], compare(
            merge, args[:4], create, f"{label} merge {i}",
            weights=kw.get("weights"), wide=kw.get("wide", False)))
    for i, (args, _kw) in enumerate(cs):
        r = results["compact_mesh"]
        r["max_abs_err"] = max(r["max_abs_err"], check_compact(
            args, f"{label} compaction {i}"))
    log(f"  {label}: kernel == plain on {len(ms)} captured per-shard merge "
        f"calls and {len(cs)} compaction calls")


def mesh_bloom_paths(dev, card, d, paths, results, by_path):
    """Phase 33: phase 10's -b24 literal two-pass over a hard link on the
    mesh (count_mesh: each shard's slice of 2^22 bits gates its routed
    batch through the sentinel post, the weighted merge folds it; pass 2
    in count mode) with bench.py's bloom gates, its dump md5-equal to the
    one-device dump; then `count -X -k31 -b24` of the reads and the
    seed-101 reads through the CLI under YAK_TPU_MESH=1 (the serial
    ranks routed with the hashes), md5-gated by EXACT_DIGEST["b24"];
    every captured merge and compaction call held against its plain
    version."""
    from yak_tpu_torch import cli
    from yak_tpu_torch.models.count import CountOpts
    from yak_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(devices=[dev] * MESH_SHARDS)
    files = [paths["reads"], os.path.join(d, "reads_link.fa")]
    os.link(*files)
    one_path, mesh_path = (os.path.join(d, f"{n}_b24.yak")
                           for n in ("one", "mesh"))
    with contextlib.redirect_stderr(io.StringIO()):
        run_bloom(files, 24, dev).dump(one_path)
    ONE_DUMP_MD5["b24"] = file_md5(one_path)
    name = "mesh b24 literal"
    opt = CountOpts(k=K, bf_shift=24, chunk_size=MESH_CHUNK, device=str(dev))
    marks = _GroupMarks()
    reset_counts()
    with captured("merge", "merge_reduce") as ms, \
            captured("compact", "compact") as cs, \
            contextlib.redirect_stderr(io.StringIO()):
        t0 = time.perf_counter()
        mt = pmesh.count_mesh(files, opt, mesh, cap_log2=MESH_CAP_LOG2,
                              hook=marks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    by_path[name] = mesh_counts(counts)
    check_gates(mt, f"{name}: wall {wall:.4f} s [{card}]", BLOOM_DISTINCT,
                BLOOM_HIST)
    check_launched(counts, ("merge_reduce_weighted", "merge_reduce",
                            "compact"), name)
    with contextlib.redirect_stderr(io.StringIO()):
        mt.dump(mesh_path)
    if file_md5(mesh_path) != file_md5(one_path):
        raise AssertionError(f"{name}: the dump differs from the one-device "
                             f"dump")
    log(f"  {name}: dump md5 {file_md5(mesh_path)} = the one-device dump's; "
        f"shard sizes {[s.tot for s in mt.shards]}")
    del mt
    split_groups(marks.marks, wall, card, name)
    mesh_kernel_checks(ms, cs, name, results)
    results["merge_reduce_weighted_mesh"] = dict(time_merge_call(
        next(c for c in ms if c[1].get("weights") is not None),
        f"{name}: shard 0's gated fold of group 0", card),
        max_abs_err=results["merge_reduce_weighted_mesh"]["max_abs_err"])
    sentinel = max((a for a, _kw in cs), key=lambda a: a[0].numel())
    results["compact_mesh"].update(time_compact(
        sentinel, f"compaction at a shard's -b24 sentinel post", card),
        max_abs_err=results["compact_mesh"]["max_abs_err"])
    del ms, cs

    name, out = "mesh -X b24", os.path.join(d, "mesh_x_b24.yak")
    used = []
    real = pmesh.count_file_mesh
    pmesh.count_file_mesh = (lambda fn, o, m, **kw: used.append(len(m))
                             or real(fn, o, m, **kw))
    os.environ["YAK_TPU_MESH"] = "1"
    reset_counts()
    try:
        with captured("merge", "merge_reduce") as ms, \
                contextlib.redirect_stderr(io.StringIO()) as err:
            t0 = time.perf_counter()
            rc = cli.main(["count", "-X", "-k31", "-b24", "--device", "cuda",
                           "-o", out, paths["reads"], paths["qv101"]])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        del os.environ["YAK_TPU_MESH"]
        pmesh.count_file_mesh = real
    if rc != 0:
        raise AssertionError(f"{name}: exit {rc}: {err.getvalue()[-2000:]}")
    counts = read_counts()
    by_path[name] = mesh_counts(counts)
    md5 = file_md5(out)
    log(f"  {name} (-k31 -b24 of reads, qv101 through the CLI on "
        f"{used} shards): dump md5 {md5} (want {EXACT_DIGEST['b24']}), "
        f"cross-check passed; wall {wall:.4f} s [{card}]")
    if used != [MESH_SHARDS] * 2 or md5 != EXACT_DIGEST["b24"]:
        raise AssertionError(f"{name}: passes on {used} shards, md5 {md5}")
    check_launched(counts, ("merge_reduce_weighted", "merge_reduce"), name)
    mesh_kernel_checks(ms, [], name, results)


def mesh_lookup_run(label, run, results, by_path, needed):
    """One lookup command on the mesh: launches counted from 0, every
    JOIN and compaction call checked; returns (run's result, wall s,
    the captured compaction calls)."""
    reset_counts()
    with captured("merge", "merge_join") as js, \
            captured("compact", "compact") as cs:
        t0 = time.perf_counter()
        text = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = read_counts()
    by_path[label] = mesh_counts(counts)
    check_launched(counts, needed, label)
    r = results["merge_join_mesh"]
    r["max_abs_err"] = max(r["max_abs_err"], check_joins(js, label))
    mesh_kernel_checks([], cs, label, results)
    return text, wall, cs


def mesh_lookup_paths(dev, card, paths, count_items, ch_texts, results,
                      by_path):
    """Phase 34: chkerr of phase 8's contigs and reads (its one-device
    output, and the contigs again at a marker budget of 64), triobin of
    seeds 7 and 8 (TB_DIGEST), trioeval of seeds 17 and 18 (TE_DIGEST)
    and sexchr (ALGEBRA_DIGEST) against tables dealt onto the mesh; every
    JOIN and compaction call held against its plain version."""
    from yak_tpu_torch.models import sexchr, trio
    from yak_tpu_torch.ops import countstep
    from yak_tpu_torch.parallel.mesh import MeshTable, make_mesh

    mesh = make_mesh(devices=[dev] * MESH_SHARDS)

    def on_mesh(table):
        return MeshTable.from_items(mesh, table.k, table.pre, *table.items())

    table = MeshTable.from_items(mesh, K, 10, *count_items)
    for kind, chunk in CHKERR_CHUNKS.items():
        label = f"mesh chkerr {kind}"
        text, wall, cs = mesh_lookup_run(
            label, lambda: run_chkerr(table, paths[kind], chunk), results,
            by_path, ("merge_join", "compact"))
        log(f"  {label} (chunk {chunk}): {text.count(chr(10))} rows, wall "
            f"{wall:.4f} s [{card}]")
        if text != ch_texts[kind]:
            raise AssertionError(f"{label}: output differs from phase 8's")
        if kind == "contigs":
            results["compact_mesh"].setdefault("shapes", {})["chkerr"] = \
                time_compact(cs[0][0], f"compaction at {label}'s markers",
                             card)
    saved = countstep.CHKERR_MAX_RUNS
    countstep.CHKERR_MAX_RUNS = 64
    try:
        text = run_chkerr(table, paths["contigs"], CHKERR_CHUNKS["contigs"])
    finally:
        countstep.CHKERR_MAX_RUNS = saved
    if text != ch_texts["contigs"]:
        raise AssertionError("mesh chkerr contigs: the output past a marker "
                             "budget of 64 differs")
    log("  mesh chkerr: outputs equal to phase 8's, also at a marker budget "
        "of 64")
    del table
    genome = np.random.default_rng(42).integers(0, 4, GENOME_LEN,
                                                dtype=np.uint8)
    tb, te = (on_mesh(t) for t in trio_tables(dev, count_items, genome))
    npos = TRIO_CONTIGS * (GENOME_LEN - K + 1)
    for cmd, table, digests, needed in (
            ("triobin", tb, TB_DIGEST, ("merge_join",)),
            ("trioeval", te, TE_DIGEST, ("merge_join", "compact"))):
        for seed, want in digests.items():
            label = f"mesh {cmd} {seed}"
            (sink, _w, _m), wall, _cs = mesh_lookup_run(
                label, lambda: trio_run(cmd, table, paths[seed],
                                        trio_opts()), results, by_path,
                needed)
            log(f"  {label}: md5 {sink.digest()} (gate {want}); wall "
                f"{wall:.4f} s, {npos / wall:.1f} positions/s [{card}]")
            if sink.digest() != want:
                raise AssertionError(f"{label}: digest {sink.digest()}")
    del tb, te
    ch = on_mesh(sexchr.load_sexchr_tables(
        *(paths[f"{n}.yak"] for n in SEXCHR_REGIONS), dev))
    buf = io.StringIO()
    _, wall, _cs = mesh_lookup_run(
        "mesh sexchr", lambda: sexchr.main_sexchr(
            sexchr.SexchrOpts(), ch, [paths["hap1"], paths["hap2"]],
            out=buf), results, by_path, ("merge_join",))
    md5 = hashlib.md5(buf.getvalue().encode()).hexdigest()[:12]
    npos = 2 * TRIO_CONTIGS * (GENOME_LEN - N_CONTIGS * (K - 1))
    log(f"  mesh sexchr: md5 {md5}; wall {wall:.4f} s, {npos / wall:.1f} "
        f"positions/s [{card}]")
    check_digest("sexchr", md5)


def mesh_slice_phases(dev, card, count_items, reads, ch_texts, results,
                      by_path):
    """Phases 33-34."""
    genome = np.random.default_rng(42).integers(0, 4, GENOME_LEN,
                                                dtype=np.uint8)
    d = tempfile.mkdtemp(prefix="yak_tpu_torch_mesh2_")
    try:
        t0 = time.perf_counter()
        paths = exact_files(d, reads)
        phase(f"33. -b on a mesh of {MESH_SHARDS} shards of the card")
        mesh_bloom_paths(dev, card, d, paths, results, by_path)
        paths["contigs"] = os.path.join(d, "contigs.fa")
        write_fasta(paths["contigs"], make_contigs(genome),
                    [b"ctg%d" % i for i in range(N_CONTIGS)])
        paths["reads"] = os.path.join(d, "reads.fq")
        write_fastq(paths["reads"], reads)
        paths.update(trio_sets(d, genome, (*TB_DIGEST, *TE_DIGEST)))
        paths.update(sexchr_files(d, genome))
        sexchr_tables(dev, d, paths)
        log(f"  inputs written in {time.perf_counter() - t0:.3f} s")
        phase(f"34. chkerr, triobin, trioeval and sexchr on a mesh of "
              f"{MESH_SHARDS} shards of the card")
        mesh_lookup_paths(dev, card, paths, count_items, ch_texts, results,
                          by_path)
    finally:
        for name in os.listdir(d):
            os.unlink(os.path.join(d, name))
        os.rmdir(d)

# -- phase 35: counting over two processes, two shards of the card each ----

MH_PROCS, MH_SHARDS = 2, 2     # a global mesh of D = 4 shards, as phase 29's
MH_TIMEOUT_S = 240             # a worker still running then fails the phase
MH_RUNS = (("multihost count", 0, False),
           ("multihost b24 literal", 24, False),
           ("multihost psort count", 0, True))
MH_ENTRIES = ("merge_reduce_mesh", "merge_reduce_weighted_mesh",
              "compact_mesh", "sort_i64_mesh")


def _host_timed(fn, name, out):
    """fn, appending (name, its host ms) to `out` at each call."""
    def timed(*args, **kw):
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        out.append((name, (time.perf_counter() - t0) * 1e3))
        return res
    return timed


def mh_worker(coord, rank, fa, link, md5s):
    """One process of phase 35 (`chip_smoke.py --multihost-worker ...`):
    MH_RUNS over the global mesh of [cuda:0] * MH_SHARDS in each of
    MH_PROCS processes joined over gloo, each run's gates, its dump
    md5-equal to the one-device dump (`md5s`), every captured merge,
    compaction and sort call held against its plain version, the device
    and host spans per group and the exchange's host time per group.
    Prints its results as one `MH_RESULT {json}` line."""
    sys.path.insert(0, ROOT)
    from yak_tpu_torch import YAK_MAX_COUNT
    from yak_tpu_torch.models.count import CountOpts
    from yak_tpu_torch.ops import cuda_build
    from yak_tpu_torch.parallel import multihost as mh

    built = cuda_build.load_all(["merge_reduce", "compact", "sort", "scan"])
    if any(secs for _lib, secs in built.values()):
        raise AssertionError("a worker built a kernel phase 2 had built")
    dev = torch.device("cuda")
    mh.init_multihost(coord, MH_PROCS, rank, backend="gloo")
    mesh = mh.global_mesh([dev] * MH_SHARDS)
    card = card_line()
    xch = []            # (exchange step, host ms) of each call
    for attr in ("gather_counts", "all_to_all"):
        setattr(mh._HostSlice, attr,
                _host_timed(getattr(mh._HostSlice, attr), attr, xch))
    mh.dist.all_to_all_single = _host_timed(mh.dist.all_to_all_single,
                                            "wire", xch)
    results = {e: {"max_abs_err": 0} for e in MH_ENTRIES}
    report = {"counts": {}, "runs": {}}
    t0 = time.perf_counter()
    mh.count_file_multihost(fa, CountOpts(k=K, chunk_size=MESH_CHUNK,
                                          device=str(dev)), mesh,
                            cap_log2=MESH_CAP_LOG2)
    torch.cuda.synchronize()
    log(f"  warm-up count (this process's first): "
        f"{time.perf_counter() - t0:.4f} s")
    real = mh.count_file_mesh
    for name, bf_shift, psort in MH_RUNS:
        marks = _GroupMarks()
        mh.count_file_mesh = lambda *a, **kw: real(*a, hook=marks, **kw)
        del xch[:]
        opt = CountOpts(k=K, bf_shift=bf_shift, chunk_size=MESH_CHUNK,
                        device=str(dev))
        try:
            with psort_engine() if psort else contextlib.nullcontext():
                reset_counts()
                with captured("merge", "merge_reduce") as ms, \
                        captured("compact", "compact") as cs, \
                        captured("sort", "sort") as ss:
                    t0 = time.perf_counter()
                    mt = mh.count_file_multihost(fa, opt, mesh,
                                                 cap_log2=MESH_CAP_LOG2)
                    if bf_shift:
                        mt.destroy_bf()
                        mt.clear_counts()
                        mh.count_file_multihost(link, opt, mesh, table=mt)
                        mt.shrink(2, YAK_MAX_COUNT)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                counts = read_counts()
        finally:
            mh.count_file_mesh = real
        report["counts"][name] = counts
        check_gates(mt, f"{name}: wall {wall:.4f} s", *(
            (BLOOM_DISTINCT, BLOOM_HIST) if bf_shift
            else (TOTAL_GATE, HIST_GATE)))
        check_launched(counts, ("merge_reduce_weighted", "merge_reduce",
                                "compact") if bf_shift else
                       ("merge_reduce",) + (("sort_i64",) if psort else ()),
                       name)
        out = os.path.join(os.path.dirname(fa), f"mh{rank}.yak")
        with contextlib.redirect_stderr(io.StringIO()):
            mt.dump(out)
        want = md5s["b24" if bf_shift else "k31"]
        if file_md5(out) != want:
            raise AssertionError(f"{name}: dump md5 {file_md5(out)} != the "
                                 f"one-device dump's {want}")
        log(f"  {name}: dump md5 {want} = the one-device dump's; local "
            f"shard sizes {[s.tot for s in mt.shards]}, capacities "
            f"{[s.cap for s in mt.shards]}")
        del mt
        busy = split_groups(marks.marks, wall, card, name)
        per = {n: [ms_ for n_, ms_ in xch if n_ == n]
               for n in ("gather_counts", "all_to_all", "wire")}
        log(f"  {name}: exchange host ms per group: counts all_gather "
            + ", ".join(f"{x:.4f}" for x in per["gather_counts"])
            + "; hashes all_to_all, staging included "
            + ", ".join(f"{x:.4f}" for x in per["all_to_all"])
            + ", of it the collective "
            + ", ".join(f"{x:.4f}" for x in per["wire"]))
        report["runs"][name] = {"wall_s": wall, "busy_ms": busy, **per}
        mesh_kernel_checks(ms, cs, name, results)
        if psort:
            check_sorts(ss, name)
        del ms, cs, ss
    report["err"] = {e: r["max_abs_err"] for e, r in results.items()}
    torch.distributed.destroy_process_group()
    log("MH_RESULT " + json.dumps(report))
    return 0


def multihost_phase(card, reads, results, by_path):
    """Phase 35: MH_PROCS copies of this script in worker mode
    (`mh_worker`), joined over gloo at a free loopback port; every worker
    must pass, and one that fails or runs past MH_TIMEOUT_S fails the
    phase, the others killed.  Their launches, summed, are the
    `multihost` path; their kernel checks' errors go into the mesh
    entries."""
    import socket

    d = tempfile.mkdtemp(prefix="yak_tpu_torch_mh_")
    procs, logs = [], []
    try:
        t0 = time.perf_counter()
        files = bloom_files(d, reads)
        log(f"  inputs written in {time.perf_counter() - t0:.3f} s")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            coord = f"127.0.0.1:{sock.getsockname()[1]}"
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        for rank in range(MH_PROCS):
            logs.append(open(os.path.join(d, f"worker{rank}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--multihost-worker", coord, str(rank), *files,
                 json.dumps(ONE_DUMP_MD5)],
                stdout=logs[-1], stderr=subprocess.STDOUT, cwd=ROOT))
        deadline = t0 + MH_TIMEOUT_S
        while (any(p.poll() is None for p in procs)
               and not any(p.returncode for p in procs)
               and time.perf_counter() < deadline):
            time.sleep(0.1)
        wall = time.perf_counter() - t0
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        reports = []
        for rank, (p, f) in enumerate(zip(procs, logs)):
            f.seek(0)
            text = f.read()
            for line in text.splitlines():
                if line.startswith("MH_RESULT "):
                    reports.append(json.loads(line[len("MH_RESULT "):]))
                else:
                    log(f"  [worker {rank}] {line}")
            if p.returncode != 0:
                raise AssertionError(
                    f"phase 35: worker {rank} exited {p.returncode} after "
                    f"{wall:.1f} s (timeout {MH_TIMEOUT_S} s)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        for name in os.listdir(d):
            os.unlink(os.path.join(d, name))
        os.rmdir(d)
    total = {}
    for rep in reports:
        for counts in rep["counts"].values():
            for n, c in counts.items():
                total[n] = total.get(n, 0) + c
        for e, err in rep["err"].items():
            results[e]["max_abs_err"] = max(results[e]["max_abs_err"], err)
    by_path["multihost"] = mesh_counts(total)
    log(f"  {MH_PROCS} workers of {MH_SHARDS} shards each passed in "
        f"{wall:.3f} s wall (their start included) [{card}]")
    w1, b1 = ONE_DEVICE["mesh count"]
    for rank, rep in enumerate(reports):
        run = rep["runs"]["multihost count"]
        log(f"  worker {rank}: k31 wall {run['wall_s']:.4f} s, device busy "
            f"{run['busy_ms']:.4f} ms, exchange (all_to_all) per group "
            + ", ".join(f"{x:.4f}" for x in run["all_to_all"])
            + f" ms; phase 29 on one process: wall {w1:.4f} s, busy "
            f"{b1:.4f} ms [{card}]")


# -- phase 36: the other engines and knobs at real size ----------------------

@contextlib.contextmanager
def knobs(settings):
    """The YAK_TPU_* variables of `settings` ({name without the prefix:
    value}) set inside the block, and as they were after; the port reads
    them at each fold and each run."""
    names = {f"YAK_TPU_{k}": v for k, v in settings.items()}
    before = {name: os.environ.get(name) for name in names}
    os.environ.update(names)
    try:
        yield
    finally:
        for name, value in before.items():
            if value is None:
                del os.environ[name]
            else:
                os.environ[name] = value


def knob_text(settings):
    return " ".join(f"YAK_TPU_{k}={v}" for k, v in settings.items())


def beside_default(what, wall, busy, units, default, card):
    """One knob run's wall and device busy time, its busy time per fold
    or chunk, beside the default engine's run of the same workload
    earlier in this script (ONE_DEVICE)."""
    line = (f"  {what}: wall {wall:.4f} s, device {busy:.4f} ms, "
            f"{busy / max(units, 1):.4f} ms a fold or chunk ({units})")
    if default in ONE_DEVICE:
        w1, b1 = ONE_DEVICE[default]
        line += (f"; the default engine ({default}): wall {w1:.4f} s, "
                 f"device {b1:.4f} ms")
    log(line + f" [{card}]")


def no_launch(counts, what, kernels=None):
    """Raise if `what` launched any kernel of `kernels` (all by
    default)."""
    hit = {n: c for n, c in counts.items()
           if c and (kernels is None or n in kernels)}
    if hit:
        raise AssertionError(f"{what} launched {hit}")


def engine_count_paths(dev, card, chunks, files, results, by_path):
    """Phase 36's count runs: each engine or knob on phase 4's chunks,
    phase 11's k=33 and phase 10's -b24 literal, gates, launches, the
    per-fold device split; every compaction call of the compact engine
    held bit for bit against compact_plain, and the third fold's call
    of the first run timed."""
    count = lambda **kw: lambda: run_count(chunks, dev, **kw)  # noqa: E731
    bloom = lambda: run_bloom(files, 24, dev)                  # noqa: E731
    runs = (   # name, knobs, run, gates, needed, kernels it must not launch
        ("compact_engine", {"ENGINE": "compact"}, count(), "count",
         ("compact",), ("merge_reduce",), "count"),
        ("xla_engine", {"ENGINE": "xla"}, count(), "count", (), None,
         "count"),
        ("compact_engine replay", {"ENGINE": "compact"},
         count(cap_log2=REPLAY_CAP_LOG2), "count", ("compact",),
         ("merge_reduce",), None),
        ("wide0 k33", {"WIDE": "0"}, count(k=K33), "k33", (), None, "k33"),
        ("compact_engine b24", {"ENGINE": "compact"}, bloom, "bloom",
         ("compact",), ("merge_reduce", "merge_reduce_weighted"),
         "b24 literal"),
        ("xla_engine b24", {"ENGINE": "xla"}, bloom, "bloom", (), None,
         "b24 literal"),
        ("sentinel0 b24", {"BLOOM_SENTINEL": "0"}, bloom, "bloom",
         ("merge_reduce_weighted", "merge_reduce"), ("compact",),
         "b24 literal"),
        ("pallas0 count", {"PALLAS": "0"}, count(), "count", (), None,
         "count"))
    gates = {"count": (TOTAL_GATE, HIST_GATE),
             "k33": (K33_DISTINCT, K33_HIST),
             "bloom": (BLOOM_DISTINCT, BLOOM_HIST)}
    err, n_checked, timed = 0, 0, None
    for name, settings, run, gate, needed, banned, default in runs:
        reset_counts()
        with knobs(settings), fold_timeline() as tl, \
                captured("compact", "compact") as cs:
            t0 = time.perf_counter()
            table = run()
            wall = time.perf_counter() - t0
        by_path[name] = counts = read_counts()
        check_gates(table, f"{name} ({knob_text(settings)}), cap "
                           f"{table.cap}", *gates[gate])
        check_launched(counts, needed, name)
        no_launch(counts, name, banned)
        if "replay" in name and table.cap <= 1 << REPLAY_CAP_LOG2:
            raise AssertionError(f"{name} never grew the table")
        del table
        busy = fold_split(tl.marks, wall, card, name)
        beside_default(name, wall, busy,
                       sum(m[0] == "start" for m in tl.marks), default, card)
        calls = [args for args, _kw in cs]
        if settings.get("ENGINE") == "compact":
            if len(calls) != counts["compact"]:
                raise AssertionError(f"{name}: {len(calls)} compaction calls "
                                     f"for {counts['compact']} launches")
            for i, args in enumerate(calls):
                err = max(err, check_compact(args, f"{name} call {i}"))
            n_checked += len(calls)
            if timed is None:
                timed = calls[-1]
        del calls, cs
    log(f"  the compact engine's {n_checked} compaction calls equal "
        f"compact_plain bit for bit")
    entry = time_compact(timed, "compaction (compact engine, third fold)",
                         card)
    r = results["compact"]
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["shapes"]["compact_engine_fold"] = entry


def exact_compact_path(card, paths, by_path):
    """Phase 32's `count -X -k31 -b24` (the reads, then the seed-101
    reads) through the CLI under YAK_TPU_ENGINE=compact: the dump's md5
    must be EXACT_DIGEST's; every compaction call checked."""
    from yak_tpu_torch import cli

    d = os.path.dirname(paths["reads"])
    out = os.path.join(d, "x_compact_b24.yak")
    name = "compact_engine -X b24"
    reset_counts()
    with knobs({"ENGINE": "compact"}), timed_exact_dump() as dump_s, \
            fold_timeline() as tl, captured("compact", "compact") as cs, \
            contextlib.redirect_stderr(io.StringIO()) as err:
        t0 = time.perf_counter()
        rc = cli.main(["count", "-X", "-k31", "-b24", "--device", "cuda",
                       "-o", out, paths["reads"], paths[101]])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{name}: exit {rc}: {err.getvalue()[-2000:]}")
    by_path[name] = counts = read_counts()
    md5 = file_md5(out)
    os.unlink(out)
    log(f"  {name}: dump md5 {md5} (want {EXACT_DIGEST['b24']}), wall "
        f"{wall:.4f} s, of it the replay, cross-check and dump "
        f"{dump_s[0]:.4f} s; phase 32's default engine: "
        "{:.4f} s, of it {:.4f} s [{}]".format(*EXACT_WALLS["b24"], card))
    if md5 != EXACT_DIGEST["b24"]:
        raise AssertionError(f"{name}: md5 {md5} != {EXACT_DIGEST['b24']}")
    check_launched(counts, ("compact",), name)
    no_launch(counts, name, ("merge_reduce", "merge_reduce_weighted"))
    for i, (args, _kw) in enumerate(cs):
        check_compact(args, f"{name} call {i}")
    log(f"  {name}: {len(cs)} compaction calls equal compact_plain")
    fold_split(tl.marks, wall - dump_s[0], card, name)


def knob_lookup_paths(dev, card, paths, count_items, ch_texts, results,
                      by_path):
    """Phase 36's lookups under JOIN=0, QV_SEG=1, MARK_COMPACT=0 and
    PALLAS=0 against phase 4's table, each with its gates and launches;
    every JOIN call of QV_SEG held against its plain version and one
    timed."""
    from yak_tpu_torch.ops import merge
    from yak_tpu_torch.table import KmerTable

    table = KmerTable(K, device=dev)
    table._set_pairs(*count_items)
    seg_joins = []
    for settings, seeds, needed in (({"JOIN": "0"}, QV_SEEDS, ()),
                                    ({"QV_SEG": "1"}, QV_SEEDS,
                                     ("merge_join",)),
                                    ({"PALLAS": "0"}, (101,), ())):
        for seed in seeds:
            name = f"{knob_text(settings)[8:].lower()} qv {seed}"
            reset_counts()
            with knobs(settings), captured("merge", "merge_join") as js:
                wall, busy = qv_run(table, paths, seed, card)
            by_path[name] = counts = read_counts()
            check_launched(counts, needed, name)
            no_launch({n: c for n, c in counts.items() if n not in needed},
                      name)
            beside_default(name, wall, busy, 8, f"qv {seed}", card)
            if settings.get("QV_SEG"):
                seg_joins += [args for args, _kw in js]
    for i, args in enumerate(seg_joins):
        check_join(args, f"QV_SEG JOIN {i}")
    log(f"  QV_SEG: {len(seg_joins)} JOIN calls (the identity as their "
        f"store lanes) equal merge_join_plain")
    args = seg_joins[-1]
    live, nq = int(args[2]), args[3].numel()
    r = results["merge_join"]
    r.setdefault("shapes", {})["qv_seg"] = time_kernel(
        merge.merge_join, merge.merge_join_plain, args,
        (12 * live + 16 * nq) / HBM_BYTES_PER_S * 1e3, None,
        f"JOIN at QV_SEG's call (cap {args[0].numel()}, live {live}, B "
        f"{nq})", card)
    del seg_joins, args

    for settings, banned in (({"MARK_COMPACT": "0"}, ("compact",)),
                             ({"JOIN": "0"}, None)):
        name = f"{knob_text(settings)[8:].lower()} chkerr reads"
        reset_counts()
        with knobs(settings):
            t0 = time.perf_counter()
            text = run_chkerr(table, paths["reads"], CHKERR_CHUNKS["reads"])
            wall = time.perf_counter() - t0
        by_path[name] = counts = read_counts()
        if text != ch_texts["reads"]:
            raise AssertionError(f"{name}: output differs from phase 8's")
        no_launch(counts, name, banned)
        log(f"  {name}: {text.count(chr(10))} rows, phase 8's text, wall "
            f"{wall:.4f} s [{card}]")
    del table


def knob_trio_algebra_paths(dev, card, count_items, d, paths, by_path):
    """Phase 36's triobin 7 under JOIN=0, trioeval 17 under
    MARK_COMPACT=0, and subtract, isec, inspect and sexchr under JOIN=0,
    with their md5 gates; under JOIN=0 no kernel launches."""
    from yak_tpu_torch.models import sexchr
    from yak_tpu_torch.models.inspect import main_inspect
    from yak_tpu_torch.table import KmerTable

    genome = np.random.default_rng(42).integers(0, 4, GENOME_LEN,
                                                dtype=np.uint8)
    tb, te = trio_tables(dev, count_items, genome)
    for cmd, table, seed, digests, settings, banned in (
            ("triobin", tb, 7, TB_DIGEST, {"JOIN": "0"}, None),
            ("trioeval", te, 17, TE_DIGEST, {"MARK_COMPACT": "0"},
             ("compact",))):
        label = f"{knob_text(settings)[8:].lower()} {cmd}"
        with knobs(settings):
            _texts, counts = trio_gated(cmd, table, paths, (seed,), digests,
                                        card, label)
        by_path[label] = counts
        no_launch(counts, label, banned)
    del tb, te

    with knobs({"JOIN": "0"}):
        other = KmerTable.restore(paths["b24"], dev)
        for op, want in (("subtract", SUBTRACT_DISTINCT),
                         ("isec", ISEC_DISTINCT)):
            t = KmerTable.restore(paths["a"], dev)
            reset_counts()
            _, wall, span = timed_op(lambda: getattr(t, op)(other))
            out = os.path.join(d, f"join0_{op}.yak")
            with contextlib.redirect_stderr(io.StringIO()):
                t.dump(out)
            md5 = file_md5(out)
            log(f"  join=0 {op}: {t.tot} keys (want {want}), dump md5 {md5};"
                f" wall {wall:.4f} s, device span {span:.4f} ms [{card}]")
            if t.tot != want:
                raise AssertionError(f"join=0 {op}: {t.tot} keys != {want}")
            check_digest(op, md5)
            by_path[f"join=0 {op}"] = counts = read_counts()
            no_launch(counts, f"join=0 {op}")
            del t
        del other
        sink = _Digest()
        reset_counts()
        with contextlib.redirect_stderr(io.StringIO()):
            _, wall, _span = timed_op(lambda: main_inspect(
                paths["a"], paths["b24"], out=sink, device=dev))
        log(f"  join=0 inspect a.yak b24.yak: md5 {sink.digest()}; wall "
            f"{wall:.4f} s [{card}]")
        check_digest("inspect2", sink.digest())
        by_path["join=0 inspect"] = counts = read_counts()
        no_launch(counts, "join=0 inspect")
        ch = sexchr.load_sexchr_tables(
            *(paths[f"{n}.yak"] for n in SEXCHR_REGIONS), dev)
        buf = io.StringIO()
        reset_counts()
        _, wall, _span = timed_op(lambda: sexchr.main_sexchr(
            sexchr.SexchrOpts(), ch, [paths["hap1"], paths["hap2"]], out=buf))
        md5 = hashlib.md5(buf.getvalue().encode()).hexdigest()[:12]
        log(f"  join=0 sexchr: md5 {md5}; wall {wall:.4f} s [{card}]")
        check_digest("sexchr", md5)
        by_path["join=0 sexchr"] = counts = read_counts()
        no_launch(counts, "join=0 sexchr")


def knob_phase(dev, card, chunks, count_items, ch_texts, lookup_paths,
               bloom_dir, results, by_path):
    """Phase 36, on phases 6-8's inputs (the qv sets, the reads as FASTQ)
    and phase 10's (the one-line FASTA of the reads and its hard link,
    also phase 32's -X input)."""
    genome = np.random.default_rng(42).integers(0, 4, GENOME_LEN,
                                                dtype=np.uint8)
    d = tempfile.mkdtemp(prefix="yak_tpu_torch_knobs_")
    try:
        t0 = time.perf_counter()
        files = [os.path.join(bloom_dir, name) for name in
                 ("bloom_reads.fa", "bloom_reads_link.fa")]
        paths = {seed: lookup_paths[seed] for seed in QV_SEEDS}
        paths["reads"] = files[0]
        paths.update(trio_sets(d, genome, (7, 17)))
        paths.update(sexchr_files(d, genome))
        algebra_tables(dev, d, count_items, paths)
        log(f"  inputs and tables made in {time.perf_counter() - t0:.3f} s")
        engine_count_paths(dev, card, chunks, files, results, by_path)
        exact_compact_path(card, paths, by_path)
        knob_lookup_paths(dev, card, lookup_paths, count_items, ch_texts,
                          results, by_path)
        knob_trio_algebra_paths(dev, card, count_items, d, paths, by_path)
    finally:
        for name in os.listdir(d):
            os.unlink(os.path.join(d, name))
        os.rmdir(d)
    if any(v in os.environ for v in KNOB_VARS):
        raise AssertionError("a knob outlived phase 36")


# -- phase 37 -----------------------------------------------------------

# the benchmark's -b37 count (sr-k31.count-b37): a pass-1 fold's B lanes
# and n_hashes x B probe lanes, and the share of each mask that is set
SCAN_SHAPES = {"runs": (16_777_156, 0.6135),
               "sparse_tail": (67_108_624, 0.5662)}


def check_scan(mask, label):
    """The kernel == torch.cummax of the set lanes on one mask."""
    from yak_tpu_torch.ops import scan

    got, want = scan.last_set_lane(mask), scan.last_set_lane_plain(mask)
    if got.dtype != torch.int32 or not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(f"{label}: last_set_lane != cummax at {bad} of "
                             f"{mask.numel()} lanes")


def scan_phase(dev, card, bloom_dir, results, by_path):
    """Phase 37: phase 10's -b37 literal again with every call of its
    gate posts' scan held against cummax, then the benchmark's shapes
    checked and timed (kernel, the scatter, cummax)."""
    from yak_tpu_torch.ops import scan
    from yak_tpu_torch.ops import sorttable as st

    files = [os.path.join(bloom_dir, name) for name in
             ("bloom_reads.fa", "bloom_reads_link.fa")]
    name = "b37 literal, scan checked"
    reset_counts()
    with captured("scan", "last_set_lane") as runs, \
            captured("scan", "last_set_lane",
                     within="yak_tpu_torch.ops.bloom") as tails:
        t0 = time.perf_counter()
        table = run_bloom(files, 37, dev)
        wall = time.perf_counter() - t0
    by_path[name] = counts = read_counts()
    check_gates(table, f"{name} -b37", BLOOM_DISTINCT, BLOOM_HIST)
    del table
    check_launched(counts, ("last_set_lane",), name)
    if counts["last_set_lane"] != len(runs) + len(tails):
        raise AssertionError(
            f"{name}: {counts['last_set_lane']} launches for "
            f"{len(runs) + len(tails)} calls")
    for site, calls in (("runs", runs), ("sparse tail", tails)):
        if not calls:
            raise AssertionError(f"{name}: no {site} call")
        for i, (args, _kw) in enumerate(calls):
            check_scan(args[0], f"{name}, {site} call {i}")
        lanes = sorted({args[0].numel() for args, _kw in calls})
        log(f"  {name}: {len(calls)} {site} calls equal cummax ({lanes[0]}-"
            f"{lanes[-1]} lanes); wall {wall:.4f} s [{card}]")
    del runs, tails
    shapes = {}
    for site, (n, density) in SCAN_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(n)
        mask = torch.rand(n, generator=g, device=dev) < density
        mask[0] = False
        check_scan(mask, f"{site} shape")
        shapes[site] = dict(time_kernel(
            scan.last_set_lane, st.last_set_lane, (mask,),
            5 * n / HBM_BYTES_PER_S * 1e3,
            lambda mask=mask: scan.last_set_lane_plain(mask),
            f"last_set_lane, {site} (n {n}, density {density})", card), n=n)
        del mask
    results["last_set_lane"] = dict(shapes["sparse_tail"], shapes=shapes)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 1
    knobs_set = [v for v in KNOB_VARS if v in os.environ]
    if knobs_set:
        # under these the folds and lookups run the kernels' plain
        # versions, so no time taken here would be the default path's
        print(f"chip_smoke: unset {', '.join(knobs_set)}: the script times "
              f"the default engines and sets each knob itself (phase 36)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from yak_tpu_torch.ops import cuda_build

    dev = torch.device("cuda")
    phase("1. card")
    card = card_line()
    log(card)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
        f"device(s)")

    phase("2. build (one nvcc per kernel source and g++ for the host "
          "library, side by side)")
    from concurrent.futures import ThreadPoolExecutor

    from yak_tpu_torch import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        host_lib = pool.submit(native.build)
        built = cuda_build.load_all(["merge_reduce", "compact", "sort",
                                     "scan"])
        log(f"  host library {host_lib.result().name} (native/fastx.cpp, "
            f"native/khlayout.cpp)")
    if not native.available():
        raise AssertionError("the native library does not load")
    for name, (_lib, secs) in built.items():
        log(f"  built {cuda_build.library_path(name).name} in {secs:.3f} s")
    log(f"  build wall {time.perf_counter() - t0:.3f} s")

    reads = make_reads()
    chunks = pack_chunks(reads)

    phase("3. kernel vs plain torch on the card")
    results = {"merge_reduce": kernel_checks(dev, chunks)}
    log(f"  [{card}]")

    phase("4. count path at real size")
    by_path = {}
    n, table = count_path(dev, card, chunks)
    by_path["count"] = {"merge_reduce": n}

    phase("5. CLI on the card vs on the CPU")
    cli_check()

    # phases 6-8's inputs and 10-12's stay for phase 36
    t0 = time.perf_counter()
    lookup_paths = write_lookup_inputs(kept_dir("lookup"), reads)
    log(f"  lookup inputs written in {time.perf_counter() - t0:.3f} s")

    phase("6. lookup kernels vs plain torch on the card")
    results.update(lookup_kernel_checks(dev, table, lookup_paths, card))

    phase("7. qv at real size")
    by_path["qv"] = {"merge_join": qv_path(table, lookup_paths, card)}

    phase("8. chkerr at real size")
    n, ch_texts = chkerr_path(table, lookup_paths, card)
    by_path["chkerr"] = {"compact": n}

    phase("9. lookup CLI on the card vs on the CPU")
    lookup_cli_check()
    count_items = table.items()         # phases 17-21 build on its keys
    del table

    bloom_dir = kept_dir("bloom")
    phase("10. the -b two-pass at real size")
    counts, merges, compacts = bloom_paths(dev, card, bloom_dir, reads)
    by_path.update(counts)

    phase("11. the k=33 count at real size")
    by_path["k33"], merges["k33"] = k33_path(dev, card, chunks)

    phase("12. the overflow replays from a 2^21-lane table")
    counts, replayed = replay_paths(dev, chunks, bloom_dir)
    by_path.update(counts)
    merges.update(replayed)

    phase("13. weighted and wide merge modes vs plain torch on the card")
    modes, count_err, sent_err, sentinel = mode_kernel_checks(
        dev, merges, compacts, card)
    del merges, compacts
    results.update(modes)
    results["merge_reduce"]["max_abs_err"] = max(
        results["merge_reduce"]["max_abs_err"], count_err)
    results["compact"]["max_abs_err"] = max(
        results["compact"]["max_abs_err"], sent_err)
    if sentinel is None:
        raise AssertionError("the -b24 paths made no compaction call")
    results["compact"]["shapes"]["sentinel_post"] = sentinel

    phase("14. count -b24 / -k33 CLI on the card vs on the CPU")
    count_cli_check()
    from yak_tpu_torch.ops import sort

    if sort.sort.launches:
        raise AssertionError(f"phases 1-14 launched the sort kernel "
                             f"{sort.sort.launches} times")
    log("  phases 1-14 launched the sort kernel 0 times")

    d = tempfile.mkdtemp(prefix="yak_tpu_torch_psort_")
    try:
        t0 = time.perf_counter()
        files = bloom_files(d, reads)
        paths = write_lookup_inputs(d, reads)
        log(f"  psort inputs written in {time.perf_counter() - t0:.3f} s")

        phase("15. sort kernel vs plain torch on the card")
        results.update(sort_kernel_checks(dev, card, chunks, files, paths,
                                          ch_texts))

        phase("16. the psort engine at real size")
        by_path.update(psort_workloads(dev, card, chunks, files, paths,
                                       ch_texts, timed=True))
    finally:
        for name in os.listdir(d):
            os.unlink(os.path.join(d, name))
        os.rmdir(d)
    count_cli_check(psort=True)
    trio_phases(dev, card, count_items, reads, results, by_path)
    algebra_phases(dev, card, count_items, reads, chunks, results, by_path)
    mesh_phases(dev, card, count_items, reads, chunks, results, by_path)
    native_phases(dev, card, reads, results, by_path)
    results["merge_reduce_weighted_mesh"] = {"max_abs_err": 0}
    results["compact_mesh"] = {"max_abs_err": 0}
    mesh_slice_phases(dev, card, count_items, reads, ch_texts, results,
                      by_path)
    phase(f"35. count over {MH_PROCS} processes, {MH_SHARDS} shards of the "
          f"card each")
    multihost_phase(card, reads, results, by_path)
    phase("36. the other engines and knobs at real size")
    knob_phase(dev, card, chunks, count_items, ch_texts, lookup_paths,
               bloom_dir, results, by_path)
    phase("37. the last-set-lane kernel vs torch.cummax on the card")
    scan_phase(dev, card, bloom_dir, results, by_path)
    torch.cuda.synchronize()

    print(json.dumps({"kernels": [
        dict(KERNELS[name], **r,
             launches=sum(c.get(name, 0) for c in by_path.values()),
             launches_by_path={p: c[name] for p, c in by_path.items()
                               if c.get(name)})
        for name, r in results.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"]:
        coord, rank, fa, link, md5s = sys.argv[2:7]
        sys.exit(mh_worker(coord, int(rank), fa, link, json.loads(md5s)))
    sys.exit(main())
