"""Computes the pinned gates of chip_smoke.py's phases 24-26 (its
ALGEBRA_DIGEST) with the JAX package, `yak_tpu`, on the CPU, from the
same seeded inputs.

chip_smoke.py builds its inputs from seed 42 (the 2 Mbp genome and the
400,000 reads of bench.py's count workload) and `algebra_files`; this
script makes the same files and runs `yak_tpu` on them:

- phase 4's table: `count_file` of the reads (k=31, chunk 2^23), held
  to bench.py's count gates; the -b24 table: that table shrunk to counts
  in [2, 1023], held to bench.py's bloom gates;
- subtract and isec of the first by the second, cntasm -c1 -x1 of the
  three assemblies (the md5 of each dump); print -c of the first, inspect
  of the first alone and against the second, sexchr of hap1 and hap2
  against the chrY, chrX and PAR tables, and groupxy of its output (the
  md5 of each stdout).

Run from the repository root on a machine with the JAX package's
dependencies (no card needed; about 2 GiB of memory and a few minutes):

    python3 tools/algebra_gates.py [scratch directory]

It prints one line a gate and last one JSON object {name: md5[:12]},
with the key counts of subtract and isec.
"""

import contextlib
import hashlib
import io
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from yak_tpu import cli as jax_cli  # noqa: E402
from yak_tpu.models.count import CountOpts, count_file  # noqa: E402
from yak_tpu.models.inspect import main_inspect  # noqa: E402
from yak_tpu.models.sexchr import (SexchrOpts, groupxy,  # noqa: E402
                                   load_sexchr_tables, main_sexchr)
from yak_tpu.table import KmerTable  # noqa: E402


def gates(table, total, digest, what):
    hd = hashlib.md5(np.ascontiguousarray(table.hist(), np.int64)
                     .tobytes()).hexdigest()[:12]
    print(f"{what}: {table.tot} keys, hist digest {hd}", flush=True)
    if (table.tot, hd) != (total, digest):
        raise SystemExit(f"{what}: want {total} / {digest}")


def main(d):
    genome = np.random.default_rng(42).integers(0, 4, cs.GENOME_LEN,
                                                dtype=np.uint8)
    paths = cs.algebra_files(d, genome, cs.make_reads())
    quiet = contextlib.redirect_stderr(io.StringIO())
    out = {}
    with quiet:
        a = count_file(paths["reads"], CountOpts(k=cs.K, chunk_size=1 << 23))
    gates(a, cs.TOTAL_GATE, cs.HIST_GATE, "phase 4's table")
    paths["a"], paths["b24"] = f"{d}/a.yak", f"{d}/b24.yak"
    with quiet:
        a.dump(paths["a"])
        a.shrink(2, 1023)
    gates(a, cs.BLOOM_DISTINCT, cs.BLOOM_HIST, "the -b24 table")
    with quiet:
        a.dump(paths["b24"])
        for name in cs.SEXCHR_REGIONS:
            count_file(paths[name], CountOpts(k=cs.K, chunk_size=1 << 23)) \
                .dump(f"{d}/{name}.yak")
    for op in ("subtract", "isec"):
        dump = f"{d}/{op}.yak"
        with quiet:
            assert jax_cli.main([op, "-o", dump, paths["a"],
                                 paths["b24"]]) == 0
        out[op] = cs.file_md5(dump)
        out[f"{op}_keys"] = KmerTable.restore(dump).tot
        print(f"{op}: {out[f'{op}_keys']} keys, md5 {out[op]}", flush=True)
    with quiet:
        assert jax_cli.main(["cntasm", "-c1", "-x1", "-o", f"{d}/cntasm.yak",
                             *(paths[f"asm{i}"]
                               for i in range(len(cs.ASM_SUBS)))]) == 0
    out["cntasm"] = cs.file_md5(f"{d}/cntasm.yak")
    print(f"cntasm: md5 {out['cntasm']}", flush=True)
    for name, fn in (
            ("print", lambda: jax_cli.main(["print", "-c", paths["a"]])),
            ("inspect", lambda: main_inspect(paths["a"])),
            ("inspect2", lambda: main_inspect(paths["a"], paths["b24"]))):
        sink = cs._Digest()
        with contextlib.redirect_stdout(sink), quiet:
            fn()
        out[name] = sink.digest()
        print(f"{name}: {sink.lines} lines, md5 {out[name]}", flush=True)
    buf = io.StringIO()
    with quiet:
        ch = load_sexchr_tables(*(f"{d}/{n}.yak" for n in cs.SEXCHR_REGIONS))
        main_sexchr(SexchrOpts(), ch, [paths["hap1"], paths["hap2"]],
                    out=buf)
    text = buf.getvalue()
    out["sexchr"] = hashlib.md5(text.encode()).hexdigest()[:12]
    lines = groupxy(io.StringIO(text))
    out["groupxy"] = hashlib.md5("".join(f"{x}\n" for x in lines)
                                 .encode()).hexdigest()[:12]
    print(f"sexchr: {text.count(chr(10))} lines, md5 {out['sexchr']}; "
          f"groupxy: {len(lines)} rows, md5 {out['groupxy']}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    if len(sys.argv) > 1:
        os.makedirs(sys.argv[1], exist_ok=True)
        main(sys.argv[1])
    else:
        with tempfile.TemporaryDirectory() as tmp:
            main(tmp)
