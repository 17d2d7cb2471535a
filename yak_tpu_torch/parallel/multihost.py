"""Counting over several processes: a mesh whose shards are spread over
the processes of a `torch.distributed` group, on one host or several.

Port of `yak_tpu/parallel/multihost.py`.  The one-process mesh
(`parallel/mesh.py`) runs unchanged over a global mesh of D = L x P
shards, L local devices in each of P processes, process-major: global
shard d = rank * L + i is this process's i-th device and owns the
hashes h with h & (D-1) == d, as on one process.

Every process reads the same file (shared storage) through the same
deterministic packer, so every process sees the same sequence of groups
of D chunks; chunk i of a group feeds global shard i, and a process
packs, uploads and extracts only the chunks of its own shards.  The
routing of a group is two collectives (`_HostSlice`): one all_gather of
each process's [L, D] counts of hashes per (source, owner), and one
all_to_all of the hashes themselves.  Each shard is a `KmerTable` that
grows and replays its overflowing folds on its own, so no control flag
has to be replicated (`yak_tpu` replicates its overflow flags because
shard_map needs one shape on every chip): the group sequence alone keeps
the processes in lockstep.  `MeshTable.items`, `hist`, `tot`, `cap` and
`dump` gather or reduce over the processes and so are collectives, which
every process must call.

Over `gloo` the exchange goes through the host (the hashes copied off
each card, over the network, and back); over `nccl` it runs between the
cards, and that is its only difference.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from yak_tpu_torch.parallel.mesh import MeshTable, _owners, count_file_mesh

TIMEOUT = datetime.timedelta(seconds=300)  # a dead peer fails the run


def init_multihost(coordinator_address, num_processes, process_id,
                   backend=None):
    """Join the process group: `coordinator_address` ("host:port", served
    by process 0), `num_processes` and this `process_id`; with all three
    None, torchrun's environment (env://).  `backend` is the caller's,
    else nccl: a mesh of CPU devices names gloo.  A collective that waits
    past TIMEOUT on a dead peer raises."""
    kwargs = {"init_method": "env://"}
    if (coordinator_address, num_processes, process_id) != (None,) * 3:
        kwargs = {"init_method": f"tcp://{coordinator_address}",
                  "world_size": num_processes, "rank": process_id}
    dist.init_process_group(backend=backend or "nccl", timeout=TIMEOUT,
                            **kwargs)


def global_mesh(devices=None):
    """This process's part of the global mesh: its L local devices, by
    default its card (cuda:LOCAL_RANK where torchrun sets LOCAL_RANK),
    else every visible card, which must exist; a device may repeat.  A
    collective: every process must give the same L, and L x P must be a
    power of two (ValueError otherwise)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("global_mesh: no CUDA device; pass devices= "
                               "for a mesh of others")
        local = os.environ.get("LOCAL_RANK")
        devices = ([int(local)] if local is not None
                   else range(torch.cuda.device_count()))
        devices = [torch.device("cuda", i) for i in devices]
    devices = tuple(torch.device(d) for d in devices)
    if dist.get_backend() == "nccl":   # the device of nccl's object gathers
        torch.cuda.set_device(devices[0])
    sizes = [None] * dist.get_world_size()
    dist.all_gather_object(sizes, len(devices))
    n_dev = sum(sizes)
    if len(set(sizes)) != 1 or n_dev & (n_dev - 1):
        raise ValueError(f"global_mesh: {sizes} devices by process; each "
                         f"process must have as many, {n_dev} in all a "
                         f"power of two (hash routing)")
    return devices


class _HostSlice:
    """This process's view of a global mesh over the default process
    group: D shards, its own `slots` (range(rank * L, rank * L + L)) on
    its L local devices, and the device its collectives run on (the CPU
    for gloo, the first local card for nccl)."""

    def __init__(self, mesh):
        self.world = dist.get_world_size()
        rank, n_local = dist.get_rank(), len(mesh)
        self.n_dev = n_local * self.world
        self.slots = range(rank * n_local, (rank + 1) * n_local)
        self.xdev = (torch.device("cpu") if dist.get_backend() == "gloo"
                     else mesh[0])

    def route(self, hv, mesh):
        """`mesh._route` over the processes: hv holds this process's
        sources' (h, valid), one a local slot that got a chunk of the
        group, in slot order.  Returns (recv, (perms, counts)): recv[i]
        on mesh[i], local shard i's hashes in `_route`'s order; perms
        this process's sources'; counts the [D, D] host matrix of every
        global source."""
        perms, rows = _owners(hv, self.n_dev, mesh[0])
        counts = self.gather_counts(rows)
        lo = self.slots.start
        sent = [h[perm[:int(row.sum())]] for (h, _valid), perm, row
                in zip(hv, perms, counts[lo:])]
        return self.all_to_all(sent, counts, mesh), (perms, counts)

    def gather_counts(self, rows):
        """The [D, D] host matrix of hashes each global source sends each
        owner, from this process's rows (int [D] each, one per local
        source that got a chunk, in slot order; absent sources send
        nothing): one all_gather."""
        mine = torch.zeros((len(self.slots), self.n_dev), dtype=torch.int64,
                           device=self.xdev)
        if rows:
            mine[:len(rows)] = torch.stack(rows).to(self.xdev)
        parts = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(parts, mine)
        return torch.cat(parts).cpu().numpy()

    def all_to_all(self, sent, counts, mesh):
        """Route the hashes: sent[s] (int64, on local source s's device)
        holds its hashes in owner order, counts[s', d] of them for owner
        d, counts the [D, D] matrix of `gather_counts`.  One
        all_to_all_single: each process sends each other one block, this
        process's sources' hashes for that process's shards, shard by
        shard and each shard's source by source.  Returns recv[i] on
        mesh[i], the hashes local shard i owns, source by source in
        global slot order, each source's in lane order (as `_route`
        gives them on one process)."""
        n_local, lo, home = len(self.slots), self.slots.start, mesh[0]
        mine = counts[lo:lo + n_local]
        # laid out on the first local device, then one copy each way
        pieces = [torch.split(h.to(home), row.tolist())
                  for h, row in zip(sent, mine)]
        send = torch.cat([torch.empty(0, dtype=torch.int64, device=home)]
                         + [p[d] for d in range(self.n_dev)
                            for p in pieces]).to(self.xdev)
        # [source process, source slot, local owner] -> [p, owner, source]
        sizes = counts[:, lo:lo + n_local].reshape(
            self.world, n_local, n_local).transpose(0, 2, 1)
        recv = torch.empty(int(sizes.sum()), dtype=torch.int64,
                           device=self.xdev)
        dist.all_to_all_single(
            recv, send, sizes.sum(axis=(1, 2)).tolist(),
            mine.reshape(n_local, self.world, n_local).sum(axis=(0, 2))
            .tolist())
        blocks = torch.split(recv.to(home), sizes.reshape(-1).tolist())
        return [torch.cat([blocks[(p * n_local + i) * n_local + s]
                           for p in range(self.world)
                           for s in range(n_local)]).to(dev)
                for i, dev in enumerate(mesh)]

    def gather(self, arr):
        """Every process's 1-D numpy `arr` (their lengths may differ),
        concatenated in rank order on every process."""
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.xdev)
        n = torch.tensor([t.numel()], device=self.xdev)
        ns = [torch.empty_like(n) for _ in range(self.world)]
        dist.all_gather(ns, n)
        ns = [int(x) for x in ns]
        pad = torch.zeros(max(ns), dtype=t.dtype, device=self.xdev)
        pad[:t.numel()] = t
        parts = [torch.empty_like(pad) for _ in range(self.world)]
        dist.all_gather(parts, pad)
        return np.concatenate([p[:m].cpu().numpy()
                               for p, m in zip(parts, ns)])

    def reduce(self, arr, op="sum"):
        """`arr` (int, or an int64 numpy array) summed ("sum") or its
        largest ("max") over the processes, on every process."""
        t = torch.as_tensor(np.asarray(arr, np.int64)).to(self.xdev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM)
        out = t.cpu().numpy()
        return int(out) if out.ndim == 0 else out


def count_file_multihost(fn, opt, mesh=None, cap_log2=None, table=None,
                         create_new=None):
    """Count one file over a global mesh (`global_mesh()` when None).

    Every process streams `fn` (shared storage); chunk i of a group
    feeds global shard i, routed as `_HostSlice` says, folded as
    `count_file_mesh` folds it.  table=None -> a new MeshTable of opt.k,
    opt.pre, 2^(cap_log2 or opt.cap_log2) lanes a shard and the Bloom
    filter of opt.bf_shift and opt.bf_n_hash dealt to the shards, in
    create mode (gated by the filter: pass 1 of -b); otherwise
    increment `table`'s existing keys only (pass 2); `create_new`
    overrides either mode.  -X (opt.exact) is refused (ValueError), as
    `yak_tpu`'s multihost layer has none.  A collective: every process
    calls it with the same arguments.  Returns the MeshTable, whose
    items/hist/dump give the whole table on every process."""
    if opt.exact:
        raise ValueError("count_file_multihost: -X (the byte-exact dump) "
                         "is not supported over several processes")
    create = table is None if create_new is None else create_new
    if table is None:
        mesh = mesh or global_mesh()
        table = MeshTable(mesh, opt.k, opt.pre, cap_log2 or opt.cap_log2,
                          bf_shift=opt.bf_shift, bf_n_hash=opt.bf_n_hash,
                          host=_HostSlice(mesh))
    return count_file_mesh(fn, opt, table.mesh, table=table,
                           create_new=create)
