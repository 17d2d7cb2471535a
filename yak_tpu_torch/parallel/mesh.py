"""Multi-device counting and lookups: a k-mer table sharded over a 1-D
mesh of devices, shard d owning the hashes h with h & (D-1) == d.

Port of `yak_tpu/parallel/mesh.py` as one process that drives every
device, as `yak_tpu`'s mesh is one `shard_map` over a 1-D `Mesh`; a
mesh over several processes is `multihost.py`'s, whose MeshTable holds
this process's shards of it and whose routing is two collectives.  A
mesh is a tuple of `torch.device`s, D a power of two.  A device may
repeat: a mesh of D shards then runs on one card, or on the CPU, as
`yak_tpu`'s tests run theirs on 8 virtual CPU devices.  The owner of a
hash is its low log2(D) bits; pre >= log2(D), so each of the dump's
2^pre shards lies within one owner and the dump equals a one-device
dump byte for byte.

A group of up to D chunks is dealt one chunk a shard, and each shard
extracts its chunk's hashes on its own device.  Every valid hash goes
to its owner shard (`_route`), whose table folds the batch
(`table.KmerTable.fold_hashes`: the batch sort, `torch.sort` or under
psort the sort kernel, then the merge-reduce kernel; or the engine that
`countstep.fold_engine` names, YAK_TPU_ENGINE=compact|xla,
YAK_TPU_WIDE=0 or YAK_TPU_PALLAS=0 on every shard) or JOINs it
(`countstep.lookup_keys`: the sort with the lane as payload, then the
JOIN, which stores each value at its lane; the sorted join where the
JOIN is off); a lookup's values go back
to the lanes they came from by the slot each lane was sent from
(`_route_back`).  These per-shard launches take the place of
`yak_tpu`'s shard_mapped kernels: `merge_reduce_presorted_mesh`
(`yak_tpu/ops/pallas_merge.py:605`), `sort_planes_mesh`
(`yak_tpu/ops/pallas_sort.py:691`) with its pass chain
`_sort_calls_mesh` / `_sort_entry_mesh` (`:631`, `:717`), and
`sort_planes32_mesh` (`:701`), whose two order restores of the lookup
post are here the JOIN's stores at the lane and the scatter by slot.

Routing is plain torch, as it is XLA in `yak_tpu`, with the exact
number of hashes of each (source, owner) pair: one read of the [D, D]
counts a group.  On one device the "copy" to the owner is the slice
itself; across devices it is `.to(owner)`.  `yak_tpu`'s all_to_all
needs static shapes, hence its per-pair route capacity
(`default_route_cap`) and the replay of a group whose route
overflowed; neither is ported, as neither is needed here.

Each shard is a `KmerTable` on its own device with its own capacity,
grown by the one-fold-late replay alone (no capacity prior, as in
`yak_tpu`'s mesh, whose chips all grow together only because
shard_map needs one shape), and settling its own plane state, so
`mesh_finalize_psort` has no counterpart.

The -b two-pass (`count_mesh`): each shard holds its slice of the
Bloom filter, the filters of its own `pre`-bit shards
(`ops/bloom.bloom_insert` with shard_shift = log2(D)), and gates the
batch routed to it in one fold (`yak_tpu`'s build_count_step with its
bloom_cfg, yak_tpu/parallel/mesh.py:338-426), so its gating batches
are a group's hashes, as a one-device table's are with flush_lanes =
D * M.  For -X, a shard's serial rank of a hash is src * M + lane
(`_serial_ranks`), the position of its window in the group's chunks.
Where that packed rank key would not fit, -X is refused before the
count (`yak_tpu`'s mesh falls back to the cheap gate instead, which
only its dump's cross-check can catch).

The lookup commands (qv, chkerr, triobin, trioeval, sexchr) take a
MeshTable through `mesh_routed_groups`, each chunk's post on the
chunk's own device (`mesh_lookup_posts`).  `yak_tpu`'s per-position
`scan_file_mesh` has no user in the port and is not ported.
"""

import sys
from dataclasses import replace

import numpy as np
import torch

from yak_tpu_torch import YAK_MAX_COUNT
from yak_tpu_torch.io import yakfmt
from yak_tpu_torch.io.chunks import ChunkSource
from yak_tpu_torch.io.pack import pack_chunk_planes
from yak_tpu_torch.models.count import _device_chunk, literal_two_pass
from yak_tpu_torch.ops import countstep
from yak_tpu_torch.table import KmerTable, check_exact_gate, makes_filter

FORCED_SHARDS = 4    # D of the mesh YAK_TPU_MESH=1 forces on one device


def make_mesh(n_devices=None, devices=None):
    """A 1-D mesh: the first `n_devices` of `devices` (all of them when
    None), or, without `devices`, the first `n_devices` CUDA devices (all
    of them when None), which must exist.  D must be a power of two; a
    device may repeat."""
    if devices is None:
        n_cuda = torch.cuda.device_count()
        n = n_devices or n_cuda
        if not 1 <= n <= n_cuda:
            raise RuntimeError(
                f"make_mesh: {n_devices or 'all'} CUDA devices asked for, "
                f"{n_cuda} present; pass devices= for a mesh of others")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"make_mesh: {n} devices asked for of "
                         f"{len(devices)}")
    if n < 1 or n & (n - 1):
        raise ValueError("mesh size must be a power of two (hash routing)")
    return tuple(devices[:n])


class MeshTable:
    """A counting table sharded over a mesh: `shards[d]`, a KmerTable on
    `mesh[d]`, holds the hashes h with h & (D-1) == d, and, where the
    options make a Bloom filter (bf_shift, bf_n_hash; bf_exact for -X),
    its slice of it.  `cap` is the largest shard's capacity (shards grow
    on their own).

    On a global mesh (`host`, a `multihost._HostSlice`), `mesh` and
    `shards` are this process's, global shards `host.slots`, of D =
    `n_dev`; `items`, `hist`, `dump`, `tot` and `cap` then gather or
    reduce over the processes, so every process must call them."""

    def __init__(self, mesh, k, pre=10, cap_log2=16, bf_shift=0,
                 bf_n_hash=4, bf_exact=False, host=None):
        self.mesh = tuple(mesh)
        self.host = host
        self.n_dev = len(self.mesh) if host is None else host.n_dev
        self.slot0 = 0 if host is None else host.slots.start
        nlog = self.n_dev.bit_length() - 1
        if pre < nlog:
            raise ValueError("pre must be >= log2(n_devices)")
        self.k, self.pre = k, pre
        self.shards = [KmerTable(k, pre, cap_log2=cap_log2, cap_hinted=True,
                                 device=dev, bf_shift=bf_shift,
                                 bf_n_hash=bf_n_hash, bf_exact=bf_exact,
                                 shard_shift=nlog) for dev in self.mesh]

    @classmethod
    def from_items(cls, mesh, k, pre, hashes, counts):
        """A table of host (hash u64, count) pairs, each dealt to its
        owner shard (the mesh-side restore)."""
        t = cls(mesh, k, pre, cap_log2=14)
        hashes = np.asarray(hashes, np.uint64)
        counts = np.asarray(counts, np.int32)
        owner = hashes & np.uint64(t.n_dev - 1)
        for d, shard in enumerate(t.shards):
            sel = owner == d
            shard._set_pairs(hashes[sel], counts[sel])
        return t

    def _reduce(self, value, op="sum"):
        """This process's `value` summed ("sum") or its largest ("max")
        over the processes of a global mesh."""
        return value if self.host is None else self.host.reduce(value, op)

    @property
    def cap(self):
        return self._reduce(max(s.cap for s in self.shards), "max")

    @property
    def tot(self):
        return self._reduce(sum(s.tot for s in self.shards))

    def destroy_bf(self):
        for s in self.shards:
            s.destroy_bf()

    def flush(self):
        for s in self.shards:
            s.flush()

    def clear_counts(self):
        for s in self.shards:
            s.clear_counts()

    def shrink(self, cmin, cmax):
        for s in self.shards:
            s.shrink(cmin, cmax)

    def items(self):
        """Host (hash u64[N], count i32[N]) over all shards, shard by
        shard; on a global mesh every process's, gathered on each (a
        collective)."""
        hs, cs = zip(*(s.items() for s in self.shards))
        h, c = np.concatenate(hs), np.concatenate(cs)
        if self.host is None:
            return h, c
        return (self.host.gather(h.view(np.int64)).view(np.uint64),
                self.host.gather(c))

    def hist(self):
        """The 1024-bin count histogram, the sum of the shards' (on a
        global mesh, of every process's: a collective)."""
        return self._reduce(sum(s.hist() for s in self.shards))

    def dump(self, path):
        """The shards' items through the one-device writer: the bytes of
        a one-device dump of the same table.  On a global mesh a
        collective, and every process writes `path`."""
        h_np, c_np = self.items()
        yakfmt.dump_yak(path, self.k, self.pre, h_np, c_np)
        print(f"[M::yak_tpu_torch] dumped the hash table to file '{path}'",
              file=sys.stderr)


# -- routing -------------------------------------------------------------

def _owners(hv, n_dev, dev0):
    """Per source (h int64 [M_s], valid bool [M_s]) of hv: its lanes in
    (owner, lane) order, a stable sort of the owners h & (D-1) (D on the
    invalid lanes), and its number of hashes for each owner, int64 [D]
    on dev0."""
    bounds = torch.arange(n_dev + 1, dtype=torch.int32)
    perms, rows = [], []
    for h, valid in hv:
        owner = torch.where(valid, h & (n_dev - 1), n_dev).to(torch.int32)
        sorted_owner, perm = torch.sort(owner, stable=True)
        perms.append(perm)
        edges = torch.searchsorted(sorted_owner, bounds.to(h.device))
        rows.append(torch.diff(edges).to(dev0))
    return perms, rows


def _route(hv, mesh):
    """Send each valid hash to its owner shard.  hv holds, for each
    source shard s (one per chunk of the group, s < D), its (h int64
    [M_s], valid bool [M_s]) on mesh[s].  Returns (recv, meta): recv[d]
    int64 [n_d] on mesh[d], the valid hashes that shard d owns, source
    by source and each source's in lane order; meta = (perm, counts),
    per source the lanes in (owner, lane) order and the host [S, D]
    numpy matrix of hashes sent from s to d, which `_route_back` uses.
    The counts are read once, as one [S, D] tensor.  A table over
    several processes routes by `multihost._HostSlice.route` instead."""
    n_dev = len(mesh)
    perms, rows = _owners(hv, n_dev, mesh[0])
    counts = torch.stack(rows).cpu().numpy()
    recv = [[] for _ in range(n_dev)]
    for (h, _valid), perm, row in zip(hv, perms, counts):
        sent = torch.split(h[perm[:int(row.sum())]], row.tolist())
        for d, part in enumerate(sent):
            recv[d].append(part.to(mesh[d]))
    return [torch.cat(parts) for parts in recv], (perms, counts)


def _serial_ranks(meta, mesh, m):
    """Each routed hash's serial rank in its group, src * m + lane (the
    window's position in the group's chunks of m lanes each, as a
    one-device fold of those chunks orders them), in receive order:
    int64 [n_d] on mesh[d], from `_route`'s meta."""
    perms, counts = meta
    parts = [[] for _ in mesh]
    for s, (perm, row) in enumerate(zip(perms, counts)):
        sent = torch.split(perm[:int(row.sum())] + s * m, row.tolist())
        for d, part in enumerate(sent):
            parts[d].append(part.to(mesh[d]))
    return [torch.cat(p) for p in parts]


def _route_back(vals, meta, mesh, lanes):
    """Return the owners' values to the lanes they came from.  vals[d]
    int32 [n_d] on mesh[d] holds shard d's value of each hash it
    received, in receive order; lanes[s] is source s's M_s.  Returns, per
    source s, int32 [M_s] on mesh[s]: each valid lane's value, -1 on the
    invalid lanes."""
    perms, counts = meta
    offs = np.cumsum(counts, axis=0) - counts   # where s starts in recv[d]
    out = []
    for s, (perm, m) in enumerate(zip(perms, lanes)):
        dev = mesh[s]
        parts = [vals[d][offs[s, d]:offs[s, d] + counts[s, d]].to(dev)
                 for d in range(len(mesh))]
        v = torch.full((m,), -1, dtype=torch.int32, device=dev)
        v[perm[:int(counts[s].sum())]] = torch.cat(parts)
        out.append(v)
    return out


def _groups(fn, chunk, k, n_dev, min_len=0, skip_empty=False):
    """Groups of up to n_dev PackedChunks (with record meta) of `fn`, in
    file order; skip_empty drops chunks without records."""
    group = []
    for packed in ChunkSource(fn, chunk, k, min_len=min_len,
                              with_meta="records"):
        if skip_empty and not len(packed.rec_gid):
            continue
        group.append(packed)
        if len(group) == n_dev:
            yield group
            group = []
    if group:
        yield group


def _extract_group(group, mesh, k, mark):
    """Chunk i of the group packed and uploaded to mesh[i] (all of them,
    then mark("h2d")), and extracted there: [(h int64 [M], valid bool
    [M])]."""
    cargs = [pack_chunk_planes(packed, dev)
             for packed, dev in zip(group, mesh)]
    mark("h2d")
    out = []
    for carg in cargs:
        h, valid = countstep.extract(carg, k)
        out.append((h.reshape(-1), valid.reshape(-1)))
    return out


# -- counting --------------------------------------------------------------

def count_file_mesh(fn, opt, mesh, cap_log2=None, table=None, hook=None,
                    create_new=None):
    """Count one file into a MeshTable: each group of D chunks extracted
    a chunk a shard, routed, and folded by each shard's `fold_hashes`.

    table=None -> a new table of opt.k, opt.pre and 2^(cap_log2 or
    opt.cap_log2) lanes a shard, with the Bloom filter of opt.bf_shift,
    opt.bf_n_hash and opt.exact dealt to the shards, create mode (pass 1
    of -b: each shard's fold of a group gated); otherwise increment the
    table's existing keys only (pass 2 of -b, recount, htab.c:71-75);
    `create_new` overrides either mode.  A table on a global mesh
    (`multihost.count_file_multihost`) gets chunk i of a group on its
    global shard i: this process extracts its own shards' chunks only.
    With -X, a count whose serial rank key would not fit is refused
    before it starts (ValueError).  `hook`, when given, is called with
    "start", "h2d", "extract", "route" and "fold" as each group's phases
    are queued."""
    create = table is None if create_new is None else create_new
    chunk = _device_chunk(opt)
    n_dev = len(mesh) if table is None else table.n_dev
    group_lanes = n_dev * (chunk - opt.k + 1)
    exact = (table is None and create and opt.exact
             and makes_filter(opt.bf_shift, opt.pre))
    if exact:               # before the filter slices are made
        check_exact_gate(opt.bf_shift, opt.bf_n_hash, group_lanes,
                         group_lanes, n_dev.bit_length() - 1)
    if table is None:
        table = MeshTable(mesh, opt.k, opt.pre, cap_log2 or opt.cap_log2,
                          bf_shift=opt.bf_shift, bf_n_hash=opt.bf_n_hash,
                          bf_exact=opt.exact)
    mark = hook or (lambda _name: None)
    route = _route if table.host is None else table.host.route
    for group in _groups(fn, chunk, opt.k, table.n_dev, min_len=opt.k):
        mark("start")
        hv = _extract_group(group[table.slot0:], table.mesh, opt.k, mark)
        mark("extract")
        recv, meta = route(hv, table.mesh)
        ranks = (_serial_ranks(meta, table.mesh, group_lanes // table.n_dev)
                 if exact else [None] * table.n_dev)
        mark("route")
        for shard, h, rank in zip(table.shards, recv, ranks):
            if h.numel():
                shard.fold_hashes(h, torch.ones_like(h, dtype=torch.bool),
                                  create, rank, group_lanes)
        mark("fold")
    table.flush()
    return table


def count_mesh(files, opt, mesh, cap_log2=None, hook=None):
    """`yak count` on a mesh, with the -b protocol of `models.count.count`
    (main.c:53-60): without -b, one count_file_mesh; with -b over one
    input (the same path twice, or one file), the same-file shortcut,
    one ungated pass; else the literal two-pass: pass 1 gated by each
    shard's filter slice, the filter destroyed and the counts cleared,
    pass 2 over files[1] (or files[0] again) increment-only.  With -b,
    then, the shrink to counts of 2 or more (yak_tpu/parallel/mesh.py:
    1147-1170, as the one-device count runs pass 2 also where the
    options make no filter).  `hook`: count_file_mesh's, for each
    pass."""
    if opt.bf_shift <= 0:
        return count_file_mesh(files[0], opt, mesh, cap_log2=cap_log2,
                               hook=hook)
    if not literal_two_pass(files, opt):
        table = count_file_mesh(files[0], replace(opt, bf_shift=0), mesh,
                                cap_log2=cap_log2, hook=hook)
    else:
        table = count_file_mesh(files[0], opt, mesh, cap_log2=cap_log2,
                                hook=hook)
        table.destroy_bf()
        table.clear_counts()
        count_file_mesh(files[1] if len(files) >= 2 else files[0], opt,
                        mesh, table=table, hook=hook)
    table.shrink(2, YAK_MAX_COUNT)
    print(f"[M::count] {table.tot} distinct k-mers after shrinking",
          file=sys.stderr)
    return table


# -- lookups ---------------------------------------------------------------

def mesh_routed_groups(fn, mtable, chunk, psort=None, hook=None):
    """Stream the chunks of `fn` that hold records through the routed
    lookup, a group of up to D at a time: yields (group, vals, valid),
    group the PackedChunks in file order and, for chunk i, vals[i] int32
    [M] (the table count of each valid window's k-mer, -1 where absent
    or invalid) and valid[i] bool [M], both on mtable.mesh[i].  Each
    owner shard sorts and JOINs the queries routed to it
    (`countstep.lookup_keys`, through the sort kernel under psort, by
    default `countstep.psort_enabled()`).  `hook`, when given, is called
    with "start", "h2d", "extract", "route", "lookup" and "back" as each
    group's phases are queued."""
    if mtable.host is not None:
        raise NotImplementedError("lookups on a table counted over several "
                                  "processes (yak_tpu's multihost layer "
                                  "only counts)")
    k = mtable.k
    if psort is None:
        psort = countstep.psort_enabled()
    mark = hook or (lambda _name: None)
    mtable.flush()
    for group in _groups(fn, chunk, k, mtable.n_dev, skip_empty=True):
        mark("start")
        hv = _extract_group(group, mtable.mesh, k, mark)
        mark("extract")
        recv, meta = _route(hv, mtable.mesh)
        mark("route")
        vals = [countstep.lookup_keys(h, torch.ones_like(h, dtype=torch.bool),
                                      s.keys, s.cnt, s.size, s.wide, psort)
                if h.numel() else h.to(torch.int32)
                for s, h in zip(mtable.shards, recv)]
        mark("lookup")
        back = _route_back(vals, meta, mtable.mesh,
                           [h.numel() for h, _valid in hv])
        mark("back")
        yield group, back, [valid for _h, valid in hv]



def mesh_lookup_posts(fn, mtable, chunk, post, psort=None, hook=None):
    """The lookup commands' stream on a mesh (the one-device
    `utils.lookup_pipeline`): each group's routed lookups
    (`mesh_routed_groups`), then post(packed, vals, valid) of each of its
    chunks, queued on the chunk's own device, all before the group's
    first chunk is yielded.  Yields (packed, post's result) in file
    order."""
    for group, vals, valid in mesh_routed_groups(fn, mtable, chunk,
                                                 psort=psort, hook=hook):
        outs = [post(p, v, ok) for p, v, ok in zip(group, vals, valid)]
        yield from zip(group, outs)
