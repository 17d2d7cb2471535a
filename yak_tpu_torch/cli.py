"""Command-line interface: `python -m yak_tpu_torch <command> [options]`.

Port of `yak_tpu/cli.py`: all 13 commands and `groupxy`, with the same
options, messages and footer (naming yak_tpu_torch).  `count` takes
`-b`, `-H`, k in [1, 63] and `-X` (YAK_TPU_EXACT_DUMP set to anything
means `-X`), the dump in the reference's khashl slot order, which needs
the native library (`native/`).  The lookups (`qv`, `chkerr`,
`triobin`, `trioeval`, `inspect`, `sexchr`) and `recount`, `subtract`
and `isec` take tables of any k in [1, 63]; `cntasm` refuses k >= 32
and `print` exits 1 on such a table, as in the JAX package.

YAK_TPU_PROFILE=<dir> writes a `torch.profiler` trace of the command
into <dir> (`utils.maybe_profile`), as the JAX package writes its
profiler trace.

The device is chosen explicitly: `--device cuda|cuda:N|cpu` anywhere
on the command line, else `cuda`.  When CUDA is asked for and absent,
the CLI raises; it never falls back to the CPU on its own.

`count`, `qv`, `chkerr`, `triobin`, `trioeval` and `sexchr` of k <= 31
run on a mesh (`_auto_mesh`, YAK_TPU_MESH) where the JAX package's CLI
runs them on its mesh; the other commands stay on one device.
"""

import os
import resource
import sys
import time

import numpy as np
import torch

from yak_tpu_torch import __version__


def _parse_num(s):
    """k/m/g size suffixes (mm_parse_num, yak-priv.h:75-84)."""
    mult = 1.0
    if s and s[-1] in "kKmMgG":
        mult = {"k": 1e3, "m": 1e6, "g": 1e9}[s[-1].lower()]
        s = s[:-1]
    return int(float(s) * mult + 0.499)


def _getopt(argv, spec):
    """Tiny getopt (ketopt-style): spec maps letter -> bool(has_arg).
    Returns (opts dict, positional args)."""
    opts, pos, i = {}, [], 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and len(a) > 1 and not a[1].isdigit():
            letter = a[1]
            if letter not in spec:
                print(f"unknown option: -{letter}", file=sys.stderr)
                sys.exit(1)
            if spec[letter]:
                arg = a[2:] if len(a) > 2 else argv[i + 1]
                if len(a) <= 2:
                    i += 1
                opts[letter] = arg
            else:
                opts[letter] = True
        else:
            pos.append(a)
        i += 1
    return opts, pos


def _usage(lines):
    print("\n".join(lines), file=sys.stderr)
    return 1


def split_device(argv):
    """Remove `--device X` / `--device=X` from argv; returns (device name
    or None, remaining argv)."""
    rest, dev, i = [], None, 0
    while i < len(argv):
        a = argv[i]
        if a == "--device":
            if i + 1 >= len(argv):
                raise ValueError("--device needs a value (cuda or cpu)")
            dev = argv[i + 1]
            i += 2
            continue
        if a.startswith("--device="):
            dev = a.split("=", 1)[1]
        else:
            rest.append(a)
        i += 1
    return dev, rest


def resolve_device(name):
    """torch.device for a device name; CUDA must be present when asked
    for."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device '{name}' asked for but CUDA is not available; "
                f"pass --device cpu to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device '{name}' (cuda or cpu)")
    return dev


def _auto_mesh(k, device):
    """The CLI's multi-device surface (yak_tpu/cli.py:55-76): with a CUDA
    device, a mesh over the largest power-of-two number of CUDA devices
    when more than one is present; YAK_TPU_MESH=0 keeps one device and
    YAK_TPU_MESH=1 forces a mesh, on one device (or the CPU) of that
    device repeated `parallel.mesh.FORCED_SHARDS` times.  k >= 32 tables
    stay on one device, as in yak_tpu."""
    flag = os.environ.get("YAK_TPU_MESH", "auto")
    if flag == "0" or k > 31:
        return None
    from yak_tpu_torch.parallel.mesh import FORCED_SHARDS, make_mesh

    n = torch.cuda.device_count() if device.type == "cuda" else 0
    if n >= 2:
        return make_mesh(1 << (n.bit_length() - 1))
    if flag == "1":
        return make_mesh(devices=[device] * FORCED_SHARDS)
    return None


def _mesh_table(t, mesh):
    """A restored KmerTable dealt onto the mesh (shard d owns the hashes
    h with h & (D-1) == d)."""
    from yak_tpu_torch.parallel.mesh import MeshTable

    h, c = t.items()
    return MeshTable.from_items(mesh, t.k, t.pre, h, c)


def main_count(argv, device):
    from yak_tpu_torch.models.count import CountOpts, count
    o, pos = _getopt(argv, {"k": 1, "p": 1, "K": 1, "t": 1, "b": 1, "H": 1,
                            "o": 1, "X": 0})
    opt = CountOpts(device=str(device))
    if "k" in o: opt.k = int(o["k"])
    if "p" in o: opt.pre = int(o["p"])
    if "K" in o: opt.chunk_size = _parse_num(o["K"])
    if "t" in o: opt.n_thread = int(o["t"])
    if "b" in o: opt.bf_shift = int(o["b"])
    if "H" in o: opt.bf_n_hash = _parse_num(o["H"])
    if "X" in o or os.environ.get("YAK_TPU_EXACT_DUMP"):
        opt.exact = True
    fn_out = o.get("o")
    if not pos:
        return _usage(["Usage: yak_tpu_torch count [options] <in.fa> "
                       "[in.fa]",
                       "Options:",
                       f"  -k INT     k-mer size [{opt.k}]",
                       f"  -p INT     prefix length [{opt.pre}]",
                       "  -b INT     set Bloom filter size to 2**INT bits; "
                       "0 to disable [0]",
                       "  -H INT     use INT hash functions for Bloom "
                       "filter [4]",
                       "  -t INT     number of worker threads [4]",
                       "  -o FILE    dump the count hash table to FILE []",
                       "  -K INT     chunk size [100m]",
                       "  -X         byte-exact dump (reference khashl"
                       " slot order)",
                       "  --device D cuda, cuda:N or cpu [cuda]"])
    if opt.pre < 10:
        print("ERROR: -p should be at least 10", file=sys.stderr)
        return 1
    if opt.k >= 64:
        print("ERROR: -k must be smaller than 64", file=sys.stderr)
        return 1
    if opt.k >= 32:
        print("WARNING: counts are inexact if -k is greater than 31",
              file=sys.stderr)
    if opt.exact and fn_out:
        from yak_tpu_torch import native
        if not native.available():     # the dump's replay needs it
            raise RuntimeError("-X needs the native library (native/), "
                               "which did not build or is disabled by "
                               "YAK_TPU_NO_NATIVE")
    mesh = _auto_mesh(opt.k, device)
    if mesh is not None:
        from yak_tpu_torch.parallel.mesh import count_mesh
        h = count_mesh(pos, opt, mesh)
    else:
        h = count(pos, opt)
    if fn_out:
        # -X: the reference's khashl slot order byte for byte
        # (io/exactdump.py); the default dump is sorted within each
        # shard (the same content, io/yakfmt.py)
        if opt.exact:
            from yak_tpu_torch.io.exactdump import dump_yak_exact
            dump_yak_exact(fn_out, h, pos, bf_shift=opt.bf_shift,
                           bf_n_hash=opt.bf_n_hash)
        else:
            h.dump(fn_out)
    return 0


def main_recount(argv, device):
    from yak_tpu_torch.models.count import recount
    from yak_tpu_torch.table import KmerTable
    o, pos = _getopt(argv, {"o": 1})
    if len(pos) < 2:
        return _usage(["Usage: yak_tpu_torch recount [-o <out.yak>] "
                       "<kmer.yak> <seq.fa>"])
    h = KmerTable.restore(pos[0], device)
    recount(pos[1], h)
    h.dump(o.get("o", "-"))
    return 0


def main_cntasm(argv, device):
    from yak_tpu_torch import YAK_MAX_COUNT
    from yak_tpu_torch.models.count import CountOpts, count_file
    from yak_tpu_torch.table import KmerTable
    o, pos = _getopt(argv, {"k": 1, "p": 1, "K": 1, "t": 1, "i": 1, "o": 1,
                            "c": 1, "x": 1, "e": 1, "s": 1, "r": 0})
    opt = CountOpts(chunk_size=_parse_num("1.9g"), device=str(device))
    min_cnt, max_cnt, max_out, check_n = 1, 1, 0, 10
    if "k" in o: opt.k = int(o["k"])
    if "c" in o: min_cnt = int(o["c"])
    if "x" in o: max_cnt = int(o["x"])
    if "e" in o: max_out = int(o["e"])
    if "s" in o: check_n = int(o["s"])
    if "p" in o: opt.pre = int(o["p"])
    if "K" in o: opt.chunk_size = _parse_num(o["K"])
    if "t" in o: opt.n_thread = int(o["t"])
    # -r (resize before merging, main.c:98) is always on: the merge
    # reserves the union's capacity before it runs
    if not pos:
        return _usage(["Usage: yak_tpu_torch cntasm [options] <in1.fa> "
                       "[in2.fa [...]]",
                       "Options:",
                       f"  -k INT     k-mer size [{opt.k}]",
                       f"  -c INT     min count [{min_cnt}]",
                       f"  -x INT     max count [{max_cnt}]",
                       f"  -p INT     prefix length [{opt.pre}]",
                       "  -r         resize before merging; use if merging "
                       "is slow",
                       f"  -t INT     number of worker threads "
                       f"[{opt.n_thread}]",
                       f"  -e INT     exclude a k-mer if absent from INT "
                       f"samples [{max_out}]",
                       f"  -s INT     shrink the hash table every INT "
                       f"samples [{check_n}]",
                       "  -K INT     chunk size [1.9g]",
                       "  -i FILE    input k-mer dump []",
                       "  -o FILE    output k-mer dump []",
                       "  --device D cuda, cuda:N or cpu [cuda]",
                       "Note: if input and output file names are identical, "
                       "input is overwritten"])
    if opt.k >= 32:
        print("ERROR: -k must be <=31", file=sys.stderr)
        return 1
    h = None
    if "i" in o:
        try:
            h = KmerTable.restore(o["i"], device)
        except (OSError, ValueError):
            print(f"WARNING: failed to read {o['i']}. Continue anyway",
                  file=sys.stderr)
    for i, fn in enumerate(pos):
        h1 = count_file(fn, opt)
        if h is None:
            h = h1
            h.shrink(min_cnt, max_cnt)
            h.set_counts(1)
        else:
            h.merge(h1, min_cnt, max_cnt)
        if i == len(pos) - 1 or (i + 1 > max_out and (i + 1) % check_n == 0):
            h.shrink(i + 1 - max_out, YAK_MAX_COUNT)
        print(f"[M::cntasm] processed file {fn}; {h.tot} distinct k-mers "
              f"in the hash table", file=sys.stderr)
    if "o" in o:
        h.dump(o["o"])
    return 0


def main_subtract(argv, device):
    from yak_tpu_torch.table import KmerTable
    o, pos = _getopt(argv, {"t": 1, "o": 1})
    if len(pos) < 2:
        return _usage(["Usage: yak_tpu_torch subtract [options] <in1.yak> "
                       "<in2.yak>"])
    h0 = KmerTable.restore(pos[0], device)
    h0.subtract(KmerTable.restore(pos[1], device))
    h0.dump(o.get("o", "-"))
    return 0


def main_isec(argv, device):
    from yak_tpu_torch.table import KmerTable
    o, pos = _getopt(argv, {"t": 1, "o": 1})
    if len(pos) < 2:
        return _usage(["Usage: yak_tpu_torch isec [options] <in1.yak> "
                       "<in2.yak> [in3.yak ...]"])
    h0 = KmerTable.restore(pos[0], device)
    for fn in pos[1:]:
        h0.isec(KmerTable.restore(fn, device))
    h0.dump(o.get("o", "-"))
    return 0


PRINT_BLOCK = 1 << 18      # k-mers formatted at a time by `print`


def kmer_text(km, cnt, k, with_counts):
    """The `print` lines of packed 2-bit k-mers (uint64) and, with
    `with_counts`, their counts, as one str: each k-mer's k bases from
    the most significant pair down, then a tab and the count in
    decimal.  Built as a uint8 matrix a row a line, its unused digit
    cells 0 and squeezed out."""
    km = np.asarray(km, np.uint64)
    shifts = np.arange(2 * (k - 1), -1, -2, dtype=np.uint64)
    rows = [np.frombuffer(b"ACGT", np.uint8)[
        ((km[:, None] >> shifts) & np.uint64(3)).astype(np.intp)]]
    if with_counts:
        c = np.asarray(cnt, np.int64)
        ndig = 1 + (c >= 10) + (c >= 100) + (c >= 1000)
        tail = np.zeros((len(c), 5), np.uint8)
        tail[:, 0] = ord("\t")
        for d in range(4):
            digit = (c // 10 ** np.maximum(ndig - 1 - d, 0)) % 10
            tail[:, d + 1] = np.where(d < ndig, ord("0") + digit, 0)
        rows.append(tail)
    rows.append(np.full((len(km), 1), ord("\n"), np.uint8))
    buf = np.concatenate(rows, axis=1).reshape(-1)
    return buf[buf != 0].tobytes().decode("ascii")


def _print_impl(argv, device):
    from yak_tpu_torch.table import KmerTable
    o, pos = _getopt(argv, {"c": 0})
    if not pos:
        return _usage(["Usage: yak_tpu_torch print [-c] <in.yak>"])
    h = KmerTable.restore(pos[0], device)
    km, c = h.getseq()
    for off in range(0, len(km), PRINT_BLOCK):
        sys.stdout.write(kmer_text(km[off:off + PRINT_BLOCK],
                                   c[off:off + PRINT_BLOCK], h.k,
                                   "c" in o))
    return 0


def main_inspect(argv, device):
    from yak_tpu_torch.models.inspect import main_inspect as insp
    o, pos = _getopt(argv, {"m": 1})
    if not pos:
        return _usage(["Usage: yak_tpu_torch inspect [options] <in1.yak> "
                       "[in2.yak]"])
    insp(pos[0], pos[1] if len(pos) > 1 else None,
         max_cnt=int(o.get("m", 20)), device=device)
    return 0


def main_qv(argv, device):
    from yak_tpu_torch.models.qv import QvOpts, main_qv as qv_main
    from yak_tpu_torch.table import KmerTable
    o, pos = _getopt(argv, {"K": 1, "t": 1, "l": 1, "f": 1, "p": 0, "e": 1,
                            "E": 0})
    opt = QvOpts()
    if "K" in o: opt.chunk_size = _parse_num(o["K"])
    if "l" in o: opt.min_len = _parse_num(o["l"])
    if "f" in o: opt.min_frac = float(o["f"])
    if "t" in o: opt.n_threads = int(o["t"])
    if "p" in o: opt.print_each = True
    if "E" in o: opt.print_err_kmer = True
    if "e" in o: opt.fpr = float(o["e"])
    if len(pos) < 2:
        return _usage(["Usage: yak_tpu_torch qv [options] <kmer.hash> "
                       "<seq.fa>"])
    ch = KmerTable.restore(pos[0], device)
    mesh = _auto_mesh(ch.k, device)
    if mesh is not None:
        ch = _mesh_table(ch, mesh)
    qv_main(opt, ch, pos[1])
    return 0


def main_chkerr(argv, device):
    from yak_tpu_torch.models.chkerr import ChkerrOpts, main_chkerr as ce
    from yak_tpu_torch.table import KmerTable
    o, pos = _getopt(argv, {"t": 1, "c": 1, "s": 1, "K": 1})
    opt = ChkerrOpts()
    if "c" in o: opt.min_cnt = int(o["c"])
    if "s" in o: opt.min_streak = int(o["s"])
    if "K" in o: opt.chunk_size = _parse_num(o["K"])
    if len(pos) < 2:
        return _usage(["Usage: yak_tpu_torch chkerr [options] <count.yak> "
                       "<seq.fa>"])
    ch = KmerTable.restore(pos[0], device)
    mesh = _auto_mesh(ch.k, device)
    if mesh is not None:
        ch = _mesh_table(ch, mesh)
    ce(opt, ch, pos[1])
    return 0


def main_triobin(argv, device):
    from yak_tpu_torch.models.trio import (TrioOpts, load_trio_tables,
                                           main_triobin as tb)
    o, pos = _getopt(argv, {"c": 1, "d": 1, "t": 1, "p": 0, "r": 1, "K": 1})
    opt = TrioOpts()
    if "c" in o: opt.min_cnt = int(o["c"])
    if "d" in o: opt.mid_cnt = int(o["d"])
    if "p" in o: opt.print_diff = True
    if "r" in o: opt.ratio_thres = float(o["r"])
    if len(pos) < 3:
        return _usage(["Usage: yak_tpu_torch triobin [options] <pat.yak> "
                       "<mat.yak> <seq.fa>"])
    ch = load_trio_tables(pos[0], pos[1], opt, device)
    mesh = _auto_mesh(ch.k, device)
    if mesh is not None:
        ch = _mesh_table(ch, mesh)
    kw = {}
    if "K" in o: kw["chunk_cap"] = _parse_num(o["K"])
    tb(opt, ch, pos[2], **kw)
    return 0


def main_trioeval(argv, device):
    from yak_tpu_torch.models.trio import (TrioOpts, load_trio_tables,
                                           main_trioeval as te)
    o, pos = _getopt(argv, {"c": 1, "d": 1, "t": 1, "n": 1, "e": 0,
                            "F": 0, "K": 1})
    opt = TrioOpts()
    kw = {}
    if "c" in o: opt.min_cnt = int(o["c"])
    if "d" in o: opt.mid_cnt = int(o["d"])
    if "n" in o: opt.min_n = int(o["n"])
    if "e" in o: opt.print_err = True
    if "F" in o: opt.print_frag = False
    if "K" in o: kw["chunk_cap"] = _parse_num(o["K"])
    if len(pos) < 3:
        return _usage(["Usage: yak_tpu_torch trioeval [options] <pat.yak> "
                       "<mat.yak> <seq.fa>"])
    ch = load_trio_tables(pos[0], pos[1], opt, device)
    mesh = _auto_mesh(ch.k, device)
    if mesh is not None:
        ch = _mesh_table(ch, mesh)
    cnt = ch.hist()
    print(f"[M::trioeval] {cnt[0 << 2 | 2]} file1-specific k-mers and "
          f"{cnt[2 << 2 | 0]} file2-specific k-mers", file=sys.stderr)
    te(opt, ch, pos[2], **kw)
    return 0


def main_sexchr(argv, device):
    from yak_tpu_torch.models.sexchr import (SexchrOpts, load_sexchr_tables,
                                             main_sexchr as sc)
    o, pos = _getopt(argv, {"t": 1, "K": 1})
    opt = SexchrOpts()
    if "K" in o: opt.chunk_size = _parse_num(o["K"])
    if len(pos) < 5:
        return _usage(["Usage: yak_tpu_torch sexchr [options] <chrY.yak> "
                       "<chrX.yak> <PAR.yak> <hap1.fa> <hap2.fa>"])
    ch = load_sexchr_tables(pos[0], pos[1], pos[2], device)
    mesh = _auto_mesh(ch.k, device)
    if mesh is not None:
        ch = _mesh_table(ch, mesh)
    sc(opt, ch, [pos[3], pos[4]])
    return 0


def main_groupxy(argv, device):
    from yak_tpu_torch.models.sexchr import groupxy
    o, pos = _getopt(argv, {"s": 1, "c": 1, "r": 1})
    if not pos:
        return _usage(["Usage: yak_tpu_torch groupxy [-s .7] [-c .3] "
                       "[-r .9] in.sexchr"])
    with open(pos[0]) as fp:
        for line in groupxy(fp, float(o.get("s", 0.7)),
                            float(o.get("c", 0.3)), float(o.get("r", 0.9))):
            print(line)
    return 0


_COMMANDS = {
    "count": main_count, "recount": main_recount, "cntasm": main_cntasm,
    "subtract": main_subtract, "isec": main_isec, "print": _print_impl,
    "qv": main_qv, "triobin": main_triobin, "trioeval": main_trioeval,
    "inspect": main_inspect, "chkerr": main_chkerr, "sexchr": main_sexchr,
    "groupxy": main_groupxy,
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    t0 = time.time()
    dev_name, argv = split_device(argv)
    if not argv:
        print("Usage: yak_tpu_torch <command> <argument>", file=sys.stderr)
        print("Command:", file=sys.stderr)
        for c in list(_COMMANDS) + ["version"]:
            print(f"  {c}", file=sys.stderr)
        return 1
    cmd = argv[0]
    if cmd == "version":
        print(__version__)
        return 0
    if cmd not in _COMMANDS:
        print("[E::main] unknown command", file=sys.stderr)
        return 1
    device = resolve_device(dev_name or "cuda")
    from yak_tpu_torch.utils import maybe_profile
    try:
        with maybe_profile(device):
            ret = _COMMANDS[cmd](argv[1:], device)
    except FileNotFoundError as e:
        # reference-style clean failure (main.c:82,267)
        print(f"ERROR: failed to open file '{e.filename or e}'",
              file=sys.stderr)
        return 1
    except (OSError, ValueError, NotImplementedError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    if ret == 0:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        cpu = ru.ru_utime + ru.ru_stime
        print(f"[M::main] Version: {__version__}", file=sys.stderr)
        print("[M::main] CMD: yak_tpu_torch " + " ".join(argv),
              file=sys.stderr)
        print(f"[M::main] Real time: {time.time() - t0:.3f} sec; "
              f"CPU: {cpu:.3f} sec; "
              f"Peak RSS: {ru.ru_maxrss / 1024.0 / 1024.0:.3f} GB",
              file=sys.stderr)
    return ret
