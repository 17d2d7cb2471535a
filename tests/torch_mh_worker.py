"""One process of an N-process CPU count over `gloo` (the port's
counterpart of tests/mh_worker.py).

Usage: python torch_mh_worker.py <coordinator> <nprocs> <pid> <shards>
       <reads.fa> <outdir>

Counts the reads over a global mesh of <shards> CPU shards in each
process (k=17, chunk 2^14, 2^10 lanes a shard, so that the shards
grow), with the -b two-pass of tests/mh_worker.py where MH_BF_SHIFT is
set, and writes this process's gathered items (<outdir>/items<pid>.npz)
and dump (<outdir>/dump<pid>.yak).  Imports no JAX.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))           # repo root (yak_tpu_torch)

import numpy as np  # noqa: E402
import torch  # noqa: E402


def check_route(reads_fa, opt, mesh, host):
    """Every group of the file routed over the processes equals, shard
    by shard and in order, the one-process route of all its chunks on
    [cpu] * D (the last group's chunks do not reach every process);
    returns the number of groups."""
    from yak_tpu_torch.models.count import _device_chunk
    from yak_tpu_torch.parallel.mesh import _extract_group, _groups, _route

    one = [torch.device("cpu")] * host.n_dev
    n = 0
    for n, group in enumerate(_groups(reads_fa, _device_chunk(opt), opt.k,
                                      host.n_dev, min_len=opt.k), 1):
        hv = _extract_group(group, one, opt.k, lambda _name: None)
        want, _meta = _route(hv, one)
        got, _meta = host.route(hv[host.slots.start:host.slots.stop], mesh)
        for i, slot in enumerate(host.slots):
            if not torch.equal(got[i], want[slot]):
                raise AssertionError(f"group {n - 1}: shard {slot}'s routed "
                                     f"batch differs from one process's")
    return n


def main():
    coord, nprocs, pid, shards, reads_fa, outdir = sys.argv[1:7]
    from yak_tpu_torch.models.count import CountOpts
    from yak_tpu_torch.parallel.multihost import (count_file_multihost,
                                                  global_mesh,
                                                  init_multihost)

    init_multihost(coord, int(nprocs), int(pid), backend="gloo")
    mesh = global_mesh([torch.device("cpu")] * int(shards))
    opt = CountOpts(k=17, chunk_size=1 << 14, cap_log2=10, device="cpu",
                    bf_shift=int(os.environ.get("MH_BF_SHIFT", "0")))
    table = count_file_multihost(reads_fa, opt, mesh)
    if opt.bf_shift:
        table.destroy_bf()
        table.clear_counts()
        count_file_multihost(reads_fa, opt, mesh, table=table)
        table.shrink(2, 1023)
    h, c = table.items()              # gathered on every process
    np.savez(os.path.join(outdir, f"items{pid}.npz"), h=h, c=c,
             cap=table.cap, local_cap=max(s.cap for s in table.shards),
             routed=check_route(reads_fa, opt, mesh, table.host))
    table.dump(os.path.join(outdir, f"dump{pid}.yak"))
    print(f"[torch_mh_worker {pid}] done: {len(h)} keys, cap {table.cap}",
          flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
