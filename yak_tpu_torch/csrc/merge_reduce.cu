// Merge-reduce of the count path, written for Hopper (sm_90a).
//
// Replaces the TPU kernel yak_tpu/ops/pallas_merge.py::_make_kernel in
// count mode (unit batch weights, create or increment-only), weighted
// mode (the `bw` plane of merge_reduce_presorted) and wide mode
// (`wide=True`, k >= 32).  It folds a sorted batch of k-mer hashes into
// the sorted count table:
//
//   table : int64 keys [0, size) ascending and unique, int32 counts;
//   batch : int64 keys ascending, invalid lanes = INT64_MAX at the tail;
//           with weights, an int32 weight >= 0 a lane (else 1 a lane);
//   out   : for every key in either stream, count = min(table count +
//           the sum of its batch lanes' weights, 1023), ascending; a
//           key absent from the table is created only with create = 1
//           and, with weights, only when its weight sum is above 0 (the
//           Bloom gate's keep rule, pallas_merge.py:328-340); n_new
//           counts the created keys; new_size is counted before
//           truncation, so new_size > cap is the overflow flag.  Writes
//           stop at cap.
//
// This is exactly sorttable.merge_batch_impl in ADD mode
// (yak_tpu/ops/sorttable.py:90-171) with the zero-weight lanes invalid.
//
// Wide mode: k >= 32 hashes use all 64 bits.  The caller carries them as
// h ^ (1 << 63), so int64 order is their unsigned order, with a raw
// 0xFF..FF clamped to 0xFF..FE so that INT64_MAX stays the invalid
// sentinel (the TPU kernel's own clamp, countstep.py:366-375).  The
// merge needs no other change, except that no int64 value is free to
// mark "no lane" (the narrow mode uses -1: its keys are >= 0); the wide
// instantiation marks the stream's first and last lanes as run edges by
// position instead.
//
// What bounds it on the H100: device-memory bytes.  A fold reads about
// 12 B x cap (table keys + counts) + 8 B x B (batch keys; 12 B with
// weights) and writes about 12 B x (cap + B) at most; the arithmetic per
// lane is a few compares.
//
// Design.  The TPU kernel runs its grid in order and carries the open
// key run's (key, partial sum) and the emitted total in SMEM from one
// grid step to the next, closing the last run with a trailing all-pad
// tile (pallas_merge.py:21-27, 293-312, 342-357, 390-399).  On Hopper the
// blocks run in parallel and in no order, and one key run can span many
// tiles (a key repeated 17,000 times spans 17 tiles here), so those
// carries become a second pass over per-tile aggregates:
//
//   1. k_partition: merge-path diagonal search, one thread per tile of
//      TILE merged lanes (table first on equal keys);
//   2. k_tile_aggregate: each block merges its table and batch slices in
//      shared memory (each lane finds its rank in the other slice by
//      binary search), finds run heads and ends (the lanes across the
//      tile edge are read from the inputs), and scans the run sums and
//      table presence within the tile; it writes the tile's segmented
//      aggregate and its run ends that need no carry;
//   3. k_scan_tiles: one block scans the tile aggregates: the open run's
//      partial sum and presence carried into every tile, the survivors
//      per tile, their output offsets, new_size and n_new;
//   4. k_scatter: each block merges and scans its tile again, adds the
//      carry to the lanes of the run it continues, and writes its
//      survivors at their offsets, stopping at cap.
//
// The merged stream is rebuilt in pass 4 rather than stored by pass 2:
// re-reading the two input slices (12 B a lane) costs fewer bytes than
// writing and re-reading a merged stream (key, weight, flag).  The
// modes are template instantiations of the same four kernels; the
// unit-weight narrow one is the count mode's code as it was.
//
// What the TPU kernel needed and this one does not:
// - a stream bit in the packed key (hash << 1 | stream) to make its tile
//   sort tie-free (pallas_merge.py:266-276): the merge path here knows
//   which stream each lane came from;
// - table presence packed into bit 27 of the summed value
//   (pallas_merge.py:29-32): presence is its own flag; saturation at
//   1023 applies after the full run sum, never per tile;
// - output planes longer than cap, truncated by a finalize pass
//   (countstep.py:947-958): writes here stop at cap and the true
//   new_size is reported, so the caller's one-step-late replay grows the
//   table and re-runs the fold;
// - a second realness test and tie rule for wide keys
//   (pallas_merge.py:273-276): the sign flip makes them ordinary int64;
// - the x64 flag flips, the 1024-aligned pending-block DMA and the
//   smoke gates of the TPU toolchain.
//
// Lookup (JOIN) mode, `yak_merge_join`: the same kernel's lookup=True
// mode (pallas_merge.py:241-262, 314-322, driven by
// countstep.run_join_lookup :1694 and lookup_pallas :1035).  Each query
// of a sorted batch gets its table count, or -1, written at its original
// lane (the query's index payload):
//
//   table   : as above;
//   queries : int64 keys ascending, invalid lanes = INT64_MAX at the
//             tail; int32 qidx = the original lane of each sorted query;
//   out     : vals[qidx[j]] = tcnt[i] where tkeys[i] == qkeys[j] for
//             some i < size, else -1; invalid lanes give -1.
//
// What bounds it: device-memory bytes again, about 12 B x size (table
// slices, read once) + 12 B x B (keys and qidx) + one scattered 4 B
// store per query; a query costs one binary search in shared memory.
//
// Design.  The merge-path partition (k_partition, table first on equal
// keys) cuts table + queries into tiles of TILE merged lanes.  Table
// keys are unique, so a query's equal table key is either in its tile's
// table slice or is the one table lane just before the slice: the lanes
// before it in the merged order are <= the query, and an equal key
// further back would repeat.  So no run carries across tiles and the
// count mode's aggregate passes are not needed: two launches, partition
// then join-and-scatter (k_join), which stages the slice and the lane
// before it in shared memory and binary-searches it for each query.
// Storing at qidx folds plookup_post's order-restoring u64 sort into
// the store: the TPU kernel emits values in key order and needed it.
// The TPU's cnt+1 value plane riding a segmented sum, its stream bit
// and its invalid-key encoding (...FFFD) are not needed either: the
// invalid lanes are the tail past the partition's nb, and k_join's
// blocks fill them with -1, TILE lanes each.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (yak_tpu_torch/ops/cuda_build.py); bound with
//        ctypes (yak_tpu_torch/ops/merge.py).

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 1024;          // merged lanes per block
constexpr int NT = 256;             // threads per tile block
constexpr int IPT = TILE / NT;      // consecutive lanes per thread
constexpr int SCAN_NT = 1024;       // threads of the one scan block
constexpr long long KINF = 0x7fffffffffffffffLL;
constexpr long long KMIN = -KINF - 1;
constexpr int MAX_COUNT = 1023;
constexpr unsigned FULL = 0xffffffffu;

// Segmented-scan element: f = a run head lies inside, s = sum since the
// last head, p = table presence since the last head.
struct Seg {
    int f;
    int s;
    int p;
};

__device__ __forceinline__ Seg seg_identity() { return Seg{0, 0, 0}; }

__device__ __forceinline__ Seg seg_combine(Seg a, Seg b) {
    Seg r;
    r.f = a.f | b.f;
    r.s = b.f ? b.s : a.s + b.s;
    r.p = b.f ? b.p : (a.p | b.p);
    return r;
}

__device__ __forceinline__ Seg shfl_up_seg(Seg v, int off) {
    Seg r;
    r.f = __shfl_up_sync(FULL, v.f, off);
    r.s = __shfl_up_sync(FULL, v.s, off);
    r.p = __shfl_up_sync(FULL, v.p, off);
    return r;
}

// Exclusive segmented scan over the block; *total gets the whole
// block's aggregate.  warp_tot holds NTH/32 entries of shared memory.
template <int NTH>
__device__ Seg block_seg_scan_excl(Seg v, Seg* warp_tot, Seg* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    Seg inc = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        Seg up = shfl_up_seg(inc, off);
        if (lane >= off) inc = seg_combine(up, inc);
    }
    Seg ex = shfl_up_seg(inc, 1);
    if (lane == 0) ex = seg_identity();
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    if (threadIdx.x == 0) {
        Seg run = seg_identity();
        for (int w = 0; w < NTH / 32; ++w) {
            Seg tw = warp_tot[w];
            warp_tot[w] = run;
            run = seg_combine(run, tw);
        }
        *total = run;
    }
    __syncthreads();
    Seg res = seg_combine(warp_tot[warp], ex);
    __syncthreads();
    return res;
}

// Exclusive sum over the block; *total gets the block's sum.
template <int NTH>
__device__ long long block_sum_excl(long long v, long long* warp_tot,
                                    long long* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    long long inc = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        long long up = __shfl_up_sync(FULL, inc, off);
        if (lane >= off) inc += up;
    }
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long run = 0;
        for (int w = 0; w < NTH / 32; ++w) {
            long long tw = warp_tot[w];
            warp_tot[w] = run;
            run += tw;
        }
        *total = run;
    }
    __syncthreads();
    long long res = warp_tot[warp] + inc - v;
    __syncthreads();
    return res;
}

// First index in a[0, n) whose value is >= v (a ascending).
__device__ __forceinline__ long long lower_bound_g(const long long* a,
                                                   long long n,
                                                   long long v) {
    long long lo = 0, hi = n;
    while (lo < hi) {
        long long mid = (lo + hi) >> 1;
        if (a[mid] < v) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__device__ __forceinline__ int lower_bound_s(const long long* a, int n,
                                             long long v) {
    int lo = 0, hi = n;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (a[mid] < v) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__device__ __forceinline__ int upper_bound_s(const long long* a, int n,
                                             long long v) {
    int lo = 0, hi = n;
    while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (a[mid] <= v) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__device__ __forceinline__ long long live_size(const int* size_ptr,
                                               long long cap) {
    long long s = *size_ptr;
    return s < 0 ? 0 : (s > cap ? cap : s);
}

struct TileSmem {
    long long sa[TILE];       // table slice
    long long sb[TILE];       // batch slice
    long long mk[TILE];       // merged keys
    int sc[TILE];             // table slice counts
    int mw[TILE];             // merged weights
    unsigned char mt[TILE];   // merged lane came from the table
    Seg warp_seg[NT / 32];
    long long warp_sum[NT / 32];
    Seg tile_total;
    long long sum_total;
    int cnt[3];
};

// One tile's merged lanes, IPT consecutive lanes per thread, after the
// within-tile segmented scan.  `cont` marks lanes of the run the tile
// continues from earlier tiles: their sum and presence still lack the
// carry.
struct TileLanes {
    long long key[IPT];
    int sum[IPT];
    bool pres[IPT];
    bool end[IPT];
    bool cont[IPT];
    bool valid[IPT];
};

// Whether a run that ends survives: with weights, a run absent from the
// table is created only when its weight sum is above 0.
template <bool WEIGHTED>
__device__ __forceinline__ bool keep_run(int create, bool pres, int sum) {
    if constexpr (WEIGHTED) return create ? (pres || sum > 0) : pres;
    return create || pres;
}

template <bool WEIGHTED, bool WIDE>
__device__ void merge_tile(long long t, const long long* A, const int* Acnt,
                           long long size, const long long* B,
                           const int* Bw, long long nb,
                           const long long* part, TileSmem& sm,
                           TileLanes& L) {
    const long long N = size + nb;
    const long long d0 = min(t * TILE, N);
    const long long d1 = min((t + 1) * TILE, N);
    const long long a0 = part[t], a1 = part[t + 1];
    const long long b0 = d0 - a0, b1 = d1 - a1;
    const int na = (int)(a1 - a0), nbt = (int)(b1 - b0);
    const int n = (int)(d1 - d0);

    for (int i = threadIdx.x; i < na; i += NT) {
        sm.sa[i] = A[a0 + i];
        sm.sc[i] = Acnt[a0 + i];
    }
    for (int j = threadIdx.x; j < nbt; j += NT) sm.sb[j] = B[b0 + j];
    __syncthreads();
    // merged rank = own index + rank in the other slice; equal keys put
    // the table lane first, as the partition did
    for (int i = threadIdx.x; i < na; i += NT) {
        long long v = sm.sa[i];
        int pos = i + lower_bound_s(sm.sb, nbt, v);
        sm.mk[pos] = v;
        sm.mw[pos] = sm.sc[i];
        sm.mt[pos] = 1;
    }
    for (int j = threadIdx.x; j < nbt; j += NT) {
        long long v = sm.sb[j];
        int pos = j + upper_bound_s(sm.sa, na, v);
        sm.mk[pos] = v;
        if constexpr (WEIGHTED) sm.mw[pos] = Bw[b0 + j];
        else sm.mw[pos] = 1;
        sm.mt[pos] = 0;
    }
    __syncthreads();

    // the merged lanes just before and just after the tile (NONE: that
    // stream has no lane there; narrow keys are >= 0, so -1 also
    // means "no lane at all")
    constexpr long long NONE = WIDE ? KMIN : -1;
    long long prev = NONE, next = NONE;
    if (d0 > 0) {
        long long pa = a0 > 0 ? A[a0 - 1] : NONE;
        long long pb = b0 > 0 ? B[b0 - 1] : NONE;
        prev = pa > pb ? pa : pb;
    }
    if (d1 < N) {
        long long qa = a1 < size ? A[a1] : KINF;
        long long qb = b1 < nb ? B[b1] : KINF;
        next = qa < qb ? qa : qb;
    }

    // thread-local segmented inclusive scan over IPT consecutive lanes
    const int base = threadIdx.x * IPT;
    Seg agg = seg_identity();
    bool head_seen[IPT];
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
        const int p = base + q;
        const bool valid = p < n;
        L.valid[q] = valid;
        long long key = -1;
        bool head = false, end = false;
        int w = 0, tab = 0;
        if (valid) {
            key = sm.mk[p];
            w = sm.mw[p];
            tab = sm.mt[p];
            const long long pk = p > 0 ? sm.mk[p - 1] : prev;
            const long long nk = p < n - 1 ? sm.mk[p + 1] : next;
            head = key != pk;
            end = key != nk;
            if constexpr (WIDE) {
                // any int64 is a wide key: the stream's edges by position
                head = head || (p == 0 && d0 == 0);
                end = end || (p == n - 1 && d1 == N);
            }
        }
        agg = seg_combine(agg, Seg{head ? 1 : 0, w, tab});
        L.key[q] = key;
        L.end[q] = end;
        L.sum[q] = agg.s;
        L.pres[q] = agg.p != 0;
        head_seen[q] = agg.f != 0;
    }

    const Seg ex = block_seg_scan_excl<NT>(agg, sm.warp_seg, &sm.tile_total);
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
        if (!head_seen[q]) {
            L.sum[q] += ex.s;
            L.pres[q] = L.pres[q] || ex.p != 0;
        }
        L.cont[q] = !head_seen[q] && ex.f == 0;
    }
}

__global__ void k_partition(const long long* __restrict__ A,
                            const int* __restrict__ size_ptr, long long cap,
                            const long long* __restrict__ B, long long nbatch,
                            long long ntiles, long long* __restrict__ part,
                            long long* __restrict__ nb_out) {
    const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (t > ntiles) return;
    const long long size = live_size(size_ptr, cap);
    const long long nb = lower_bound_g(B, nbatch, KINF);
    const long long N = size + nb;
    const long long d = min(t * TILE, N);
    long long lo = d - nb > 0 ? d - nb : 0;
    long long hi = d < size ? d : size;
    while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (A[mid] <= B[d - 1 - mid]) lo = mid + 1; else hi = mid;
    }
    part[t] = lo;
    if (t == 0) *nb_out = nb;
}

// Per tile: seg[3t..3t+2] = segmented aggregate (f, s, p);
// cnt[3t] = run ends kept without a carry, cnt[3t+1] = of those, created
// keys, cnt[3t+2] = 0, or 1 + the tile's part of its sum (1 without
// weights) when the continued run ends in this tile.  At most one lane
// of a tile ends the continued run.
template <bool WEIGHTED, bool WIDE>
__global__ void __launch_bounds__(NT)
k_tile_aggregate(const long long* __restrict__ A, const int* __restrict__ Acnt,
                 const int* __restrict__ size_ptr, long long cap,
                 const long long* __restrict__ B, const int* __restrict__ Bw,
                 const long long* __restrict__ nb_ptr,
                 const long long* __restrict__ part, int create,
                 int* __restrict__ seg, int* __restrict__ cnt) {
    __shared__ TileSmem sm;
    const long long t = blockIdx.x;
    if (threadIdx.x < 3) sm.cnt[threadIdx.x] = 0;
    TileLanes L;
    merge_tile<WEIGHTED, WIDE>(t, A, Acnt, live_size(size_ptr, cap), B, Bw,
                               *nb_ptr, part, sm, L);
    int kept = 0, created = 0, cont_end = 0;
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
        if (!L.valid[q] || !L.end[q]) continue;
        if (L.cont[q]) {
            cont_end = WEIGHTED ? 1 + L.sum[q] : 1;
        } else if (keep_run<WEIGHTED>(create, L.pres[q], L.sum[q])) {
            ++kept;
            if (!L.pres[q]) ++created;
        }
    }
    if (kept) atomicAdd(&sm.cnt[0], kept);
    if (created) atomicAdd(&sm.cnt[1], created);
    if (cont_end) atomicOr(&sm.cnt[2], cont_end);
    __syncthreads();
    if (threadIdx.x == 0) {
        seg[3 * t] = sm.tile_total.f;
        seg[3 * t + 1] = sm.tile_total.s;
        seg[3 * t + 2] = sm.tile_total.p;
        cnt[3 * t] = sm.cnt[0];
        cnt[3 * t + 1] = sm.cnt[1];
        cnt[3 * t + 2] = sm.cnt[2];
    }
}

// One block: the carry into every tile (carry[2t] = sum, carry[2t+1] =
// presence), the output offset of every tile's survivors, new_size and
// n_new.
template <bool WEIGHTED>
__global__ void __launch_bounds__(SCAN_NT)
k_scan_tiles(long long ntiles, int create, const int* __restrict__ seg,
             const int* __restrict__ cnt, int* __restrict__ carry,
             long long* __restrict__ out_off, int* __restrict__ new_size,
             int* __restrict__ n_new) {
    __shared__ Seg warp_seg[SCAN_NT / 32];
    __shared__ long long warp_sum[SCAN_NT / 32];
    __shared__ Seg seg_total;
    __shared__ long long sum_total;
    const long long per = (ntiles + SCAN_NT - 1) / SCAN_NT;
    const long long t0 = min(threadIdx.x * per, ntiles);
    const long long t1 = min(t0 + per, ntiles);

    Seg agg = seg_identity();
    for (long long t = t0; t < t1; ++t)
        agg = seg_combine(agg, Seg{seg[3 * t], seg[3 * t + 1], seg[3 * t + 2]});
    Seg run = block_seg_scan_excl<SCAN_NT>(agg, warp_seg, &seg_total);

    long long kept = 0, created = 0;
    for (long long t = t0; t < t1; ++t) {
        carry[2 * t] = run.s;
        carry[2 * t + 1] = run.p;
        long long k = cnt[3 * t];
        long long c = cnt[3 * t + 1];
        if (cnt[3 * t + 2]) {
            // the run continued from earlier tiles ends here: its
            // presence is the carried one, its sum the carried one plus
            // this tile's part
            const bool pres = run.p != 0;
            if (keep_run<WEIGHTED>(create, pres, run.s + cnt[3 * t + 2] - 1)) {
                ++k;
                if (!pres) ++c;
            }
        }
        out_off[t] = k;
        kept += k;
        created += c;
        run = seg_combine(run, Seg{seg[3 * t], seg[3 * t + 1], seg[3 * t + 2]});
    }
    long long off = block_sum_excl<SCAN_NT>(kept, warp_sum, &sum_total);
    for (long long t = t0; t < t1; ++t) {
        const long long k = out_off[t];
        out_off[t] = off;
        off += k;
    }
    if (threadIdx.x == 0) *new_size = (int)sum_total;
    block_sum_excl<SCAN_NT>(created, warp_sum, &sum_total);
    if (threadIdx.x == 0) *n_new = (int)sum_total;
}

template <bool WEIGHTED, bool WIDE>
__global__ void __launch_bounds__(NT)
k_scatter(const long long* __restrict__ A, const int* __restrict__ Acnt,
          const int* __restrict__ size_ptr, long long cap,
          const long long* __restrict__ B, const int* __restrict__ Bw,
          const long long* __restrict__ nb_ptr,
          const long long* __restrict__ part, int create,
          const int* __restrict__ carry,
          const long long* __restrict__ out_off,
          long long* __restrict__ okeys, int* __restrict__ ocnt) {
    __shared__ TileSmem sm;
    const long long t = blockIdx.x;
    TileLanes L;
    merge_tile<WEIGHTED, WIDE>(t, A, Acnt, live_size(size_ptr, cap), B, Bw,
                               *nb_ptr, part, sm, L);
    const int c_sum = carry[2 * t];
    const bool c_pres = carry[2 * t + 1] != 0;
    bool keep[IPT];
    int mine = 0;
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
        if (L.cont[q]) {
            L.sum[q] += c_sum;
            L.pres[q] = L.pres[q] || c_pres;
        }
        keep[q] = L.valid[q] && L.end[q] &&
                  keep_run<WEIGHTED>(create, L.pres[q], L.sum[q]);
        mine += keep[q] ? 1 : 0;
    }
    long long pos = out_off[t] +
                    block_sum_excl<NT>(mine, sm.warp_sum, &sm.sum_total);
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
        if (!keep[q]) continue;
        if (pos < cap) {
            okeys[pos] = L.key[q];
            ocnt[pos] = L.sum[q] < MAX_COUNT ? L.sum[q] : MAX_COUNT;
        }
        ++pos;
    }
}

// Lookup mode: block t joins tile t's queries against its table slice
// plus the table lane just before it, stores each result at the query's
// original lane, and fills TILE lanes of the invalid tail with -1.
__global__ void __launch_bounds__(NT)
k_join(const long long* __restrict__ A, const int* __restrict__ Acnt,
       const int* __restrict__ size_ptr, long long cap,
       const long long* __restrict__ B, const int* __restrict__ qidx,
       long long nbatch, const long long* __restrict__ nb_ptr,
       const long long* __restrict__ part, int* __restrict__ vals) {
    __shared__ long long sa[TILE + 1];
    __shared__ int sc[TILE + 1];
    const long long t = blockIdx.x;
    const long long size = live_size(size_ptr, cap);
    const long long nb = *nb_ptr;
    const long long N = size + nb;
    const long long d0 = min(t * TILE, N);
    const long long d1 = min((t + 1) * TILE, N);
    const long long a0 = part[t], a1 = part[t + 1];
    const long long b0 = d0 - a0, b1 = d1 - a1;
    const long long s0 = a0 > 0 ? a0 - 1 : 0;
    const int na = (int)(a1 - s0);
    for (int i = threadIdx.x; i < na; i += NT) {
        sa[i] = A[s0 + i];
        sc[i] = Acnt[s0 + i];
    }
    __syncthreads();
    for (long long j = b0 + threadIdx.x; j < b1; j += NT) {
        const long long q = B[j];
        const int p = lower_bound_s(sa, na, q);
        vals[qidx[j]] = (p < na && sa[p] == q) ? sc[p] : -1;
    }
    const long long e0 = nb + t * TILE;
    const long long e1 = min(e0 + TILE, nbatch);
    for (long long j = e0 + threadIdx.x; j < e1; j += NT) vals[qidx[j]] = -1;
}

struct ReduceArgs {
    const long long* tkeys;
    const int* tcnt;
    const int* size;
    long long cap;
    const long long* bkeys;
    const int* bweights;
    long long nbatch;
    int create;
    long long ntiles;
    long long* part;
    long long* nb;
    int* seg;
    int* cnt;
    int* carry;
    long long* out_off;
    long long* okeys;
    int* ocnt;
    int* new_size;
    int* n_new;
    cudaStream_t s;
};

// The four launches of one merge-reduce in one mode.
template <bool WEIGHTED, bool WIDE>
int launch_reduce(const ReduceArgs& a) {
    const long long pblocks = (a.ntiles + 1 + 255) / 256;
    k_partition<<<(unsigned)pblocks, 256, 0, a.s>>>(
        a.tkeys, a.size, a.cap, a.bkeys, a.nbatch, a.ntiles, a.part, a.nb);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    k_tile_aggregate<WEIGHTED, WIDE><<<(unsigned)a.ntiles, NT, 0, a.s>>>(
        a.tkeys, a.tcnt, a.size, a.cap, a.bkeys, a.bweights, a.nb, a.part,
        a.create, a.seg, a.cnt);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    k_scan_tiles<WEIGHTED><<<1, SCAN_NT, 0, a.s>>>(
        a.ntiles, a.create, a.seg, a.cnt, a.carry, a.out_off, a.new_size,
        a.n_new);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    k_scatter<WEIGHTED, WIDE><<<(unsigned)a.ntiles, NT, 0, a.s>>>(
        a.tkeys, a.tcnt, a.size, a.cap, a.bkeys, a.bweights, a.nb, a.part,
        a.create, a.carry, a.out_off, a.okeys, a.ocnt);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int yak_merge_reduce_tile(void) { return TILE; }

// Lookup mode.  Scratch: part[ntiles + 1], nb[1], with ntiles =
// ceil((cap + nbatch) / TILE) >= 1 (enough tiles for the merged lanes
// and for the invalid tail).  Returns the first CUDA error (0 = none).
int yak_merge_join(const long long* tkeys, const int* tcnt, const int* size,
                   long long cap, const long long* qkeys, const int* qidx,
                   long long nbatch, long long ntiles, long long* part,
                   long long* nb, int* vals, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long pblocks = (ntiles + 1 + 255) / 256;
    k_partition<<<(unsigned)pblocks, 256, 0, s>>>(tkeys, size, cap, qkeys,
                                                  nbatch, ntiles, part, nb);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    k_join<<<(unsigned)ntiles, NT, 0, s>>>(tkeys, tcnt, size, cap, qkeys,
                                           qidx, nbatch, nb, part, vals);
    return (int)cudaGetLastError();
}

const char* yak_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Scratch (all device memory, from the caller): part[ntiles + 1],
// nb[1], seg[3 * ntiles], cnt[3 * ntiles], carry[2 * ntiles],
// out_off[ntiles], with ntiles = ceil((cap + nbatch) / TILE) >= 1.
// bweights: one int32 weight >= 0 per batch lane, or null for unit
// weights (count mode); wide: the keys are wide-encoded k >= 32 hashes.
// Returns the first CUDA error of the launches (0 = none).
int yak_merge_reduce(const long long* tkeys, const int* tcnt,
                     const int* size, long long cap, const long long* bkeys,
                     const int* bweights, long long nbatch, int create,
                     int wide, long long ntiles, long long* part,
                     long long* nb, int* seg, int* cnt, int* carry,
                     long long* out_off, long long* okeys, int* ocnt,
                     int* new_size, int* n_new, void* stream) {
    const ReduceArgs a{tkeys, tcnt, size, cap, bkeys, bweights, nbatch,
                       create, ntiles, part, nb, seg, cnt, carry, out_off,
                       okeys, ocnt, new_size, n_new,
                       static_cast<cudaStream_t>(stream)};
    if (bweights)
        return wide ? launch_reduce<true, true>(a)
                    : launch_reduce<true, false>(a);
    return wide ? launch_reduce<false, true>(a)
                : launch_reduce<false, false>(a);
}

}  // extern "C"
