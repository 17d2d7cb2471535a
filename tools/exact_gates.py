"""Computes the pinned gates of chip_smoke.py's phase 32 (its
EXACT_DIGEST) with the JAX package, `yak_tpu`, on the CPU, from the same
seeded inputs.

chip_smoke.py builds its inputs from seed 42 (the 2 Mbp genome and the
400,000 reads of bench.py's count workload) and seed 101 (bench.py's qv
read set); `exact_files` writes the reads as one-line FASTA (phase 10's
file) and the seed-101 reads beside them, and this script runs
`python -m yak_tpu count -X` on them, in this process, for each of
chip_smoke.EXACT_CONFIGS:

- k31: `count -X -k31` of the reads;
- b24: `count -X -b24` with pass 1 the reads and pass 2 the seed-101
  reads (two different files: the serial-exact Bloom gate decides which
  pass-1 keys the second pass recounts);
- k33: `count -X -k33` of the reads.

Each dump passes yak_tpu's own cross-check against its table (or the
run raises).  Run from the repository root on a machine with the JAX
package's dependencies (no card needed; about 3 GiB of memory and a few
minutes):

    python3 tools/exact_gates.py [scratch directory]

It prints one line a configuration and last one JSON object
{name: md5[:12]}.
"""

import contextlib
import io
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import chip_smoke as cs  # noqa: E402
from yak_tpu import cli as jax_cli  # noqa: E402


def main(d):
    paths = cs.exact_files(d, cs.make_reads())
    out = {}
    for name, (flags, files) in cs.EXACT_CONFIGS.items():
        dump = os.path.join(d, f"{name}.yak")
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            rc = jax_cli.main(["count", "-X", *flags, "-o", dump,
                               *(paths[f] for f in files)])
        if rc != 0:
            raise SystemExit(f"{name}: yak_tpu count -X exited {rc}")
        out[name] = cs.file_md5(dump)
        print(f"{name}: count -X {' '.join(flags)} of {', '.join(files)}: "
              f"md5 {out[name]} ({os.path.getsize(dump)} bytes, "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    if len(sys.argv) > 1:
        os.makedirs(sys.argv[1], exist_ok=True)
        main(sys.argv[1])
    else:
        with tempfile.TemporaryDirectory() as tmp:
            main(tmp)
