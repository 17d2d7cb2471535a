// Merge-reduce and merge-JOIN of the count and lookup paths, written for
// Hopper (sm_90a): one pass over the merged stream, with a decoupled
// look-back for what crosses tiles.
//
// Replaces the TPU kernel yak_tpu/ops/pallas_merge.py::_make_kernel
// (:155) in count mode (unit batch weights, create or increment-only),
// weighted mode (the `bw` plane of merge_reduce_presorted, :336), wide
// mode (`wide=True`, k >= 32) and lookup mode (:241).  The merge-reduce
// folds a sorted batch of k-mer hashes into the sorted count table:
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
// sentinel (the TPU kernel's own clamp, countstep.py:366-375).  Since
// run edges go by key and, at the stream's two ends, by position, no
// int64 value is reserved, and wide keys run through the same
// instantiation as the count mode's.
//
// Lookup (JOIN) mode, `yak_merge_join` (countstep.run_join_lookup :1694,
// lookup_pallas :1035): each query of a sorted batch gets its table
// count, or -1, written at its original lane (the query's index payload):
//
//   queries : int64 keys ascending, invalid lanes = INT64_MAX at the
//             tail; int32 qidx = the original lane of each sorted query;
//   out     : vals[qidx[j]] = tcnt[i] where tkeys[i] == qkeys[j] for
//             some i < size, else -1; invalid lanes give -1.
//
// What bounds them on the H100: device-memory bytes.  A fold reads 12 B
// a live table lane and 8 B a batch lane (12 B with weights) and writes
// 12 B a surviving key; a JOIN reads 12 B a live table lane and a query
// lane and stores 4 B a query at its original lane.  The arithmetic is a
// few compares a lane.  The kernels' own cost is latency: the search for
// each tile's and each thread's place in the merged order, and the wait
// for what earlier tiles carry.
//
// Design.  The TPU kernel runs its grid in order and carries the open
// key run's (key, partial sum) and the emitted total in SMEM from one
// grid step to the next (pallas_merge.py:21-27, 293-312, 342-357).  Here:
//
//   1. k_partition, PART_LANES = 8 lanes a tile edge: the merge-path
//      split of the merged stream (table first on equal keys) at every
//      multiple of TILE lanes, found with 8 probes a step (8 dependent
//      steps for 2^23 table lanes: the probes' scattered reads, not the
//      steps, bound it), and a flag on the tiles whose first lane is an
//      INT64_MAX batch lane.  The batch's INT64_MAX tail is merged as
//      ordinary lanes (no valid key equals INT64_MAX: narrow keys are
//      < 2^62, wide keys are clamped), so no search for the valid batch
//      length is needed; a lane is valid if and only if its key is not
//      INT64_MAX.
//   2. One persistent main kernel: as many blocks as the card holds at
//      once, each taking tile IDs from an atomic counter.  A block claims
//      its next tile while it starts the current one and loads the next
//      tile's slices (the table's keys and counts, the batch's keys and
//      weights or query lanes, and the one lane on each side of the tile)
//      into the other of two shared-memory stages with 16-byte cp.async
//      copies, rounded out to 16-byte segments.  Tiles past the live
//      length, cap + nbatch being only the host's bound, are never
//      visited; the first tile flagged by step 1 ends the merge-reduce.
//   3. Each thread finds its own diagonal in the tile's two slices (12
//      steps in shared memory) and merges its IPT lanes into registers,
//      table first on equal keys.  Run heads and ends come from the
//      neighbouring keys: registers within a thread, the lanes before
//      and after its diagonal in shared memory across threads, and the
//      loaded edge lanes across tiles; the stream's first lane is a head
//      and its last lane an end by position.
//   4. A block scan gives every lane its run's sum s (saturated at 2^30,
//      which is exact: weights are >= 0, the output is min(s, 1023) and
//      the keep rule tests s > 0) and table presence p within the tile,
//      and the tile's segmented aggregate (f = a head inside, s, p).
//   5. Two decoupled look-backs a tile, each by one warp reading 32
//      status words a step: (a) the run carry, the (s, p) of the run
//      open at the tile's start, needed only when a run continued from
//      earlier tiles ends
//      in this one (or the tile holds no head, to publish its inclusive
//      value); the aggregate depends on the tile's own lanes, so it is
//      published before any wait, and a tile with a head publishes it as
//      its inclusive value at once; the look-back combines earlier (+)
//      later and stops at the first inclusive word.  (b) The survivor
//      offset: with the carry the tile knows whether the continued run
//      survives, hence its exact survivor count; it publishes that count
//      (at once when no carry can change it), looks back, and publishes
//      the inclusive count.  When no carry can change the count (count
//      mode with create = 1, or no continued run ending in the tile),
//      warp 1 runs (b) while warp 0 runs (a).  A tile waits only on
//      smaller tile IDs, each running or claimed by a running block
//      behind its current tile, so the smallest unfinished tile always
//      advances; a block claims one tile ahead only, since every later
//      tile's look-back waits on a claimed tile that has not started.
//   6. The tile's survivors (key, min(s, 1023)) are staged in shared
//      memory in output order and written as one contiguous range from
//      the tile's offset, stopping at cap; new_size and n_new are one
//      integer atomicAdd a tile each.
//
// The JOIN runs the same partition, loader and per-thread merge with no
// look-back: table keys are unique and come first on equal keys, so a
// query matches exactly when the last table lane before it in merged
// order (in the tile, or the loaded lane before the tile) has its key.
// Tiles of the INT64_MAX tail only store -1 at their queries' lanes.  The
// store at qidx folds plookup_post's order-restoring sort into the JOIN.
//
// Tile: NT = 256 threads x IPT = 16 lanes = 4096 merged lanes.  Two
// stages of (4096 + 16) x 12 B take 98.7 KB of shared memory, so two
// blocks fit an SM (512 threads, up to 128 registers a thread); larger
// tiles would leave one block an SM and no other block to cover a
// block's look-back waits.  Tiles of 2048 lanes (256 x 8 or 128 x 16,
// three or four blocks an SM) and 512 x 8 ran slower on the H100 at a
// count fold's shape.
//
// Each call is three launches: one cudaMemsetAsync (tile counter,
// new_size, n_new and the status words), the partition and the main
// kernel.  Every index is 64-bit.
//
// What the TPU kernel needed and this one does not:
// - a stream bit in the packed key (hash << 1 | stream) to make its tile
//   sort tie-free (pallas_merge.py:266-276): the merge path here knows
//   which stream each lane came from;
// - table presence packed into bit 27 of the summed value
//   (pallas_merge.py:29-32): presence is its own bit of the carry;
// - output planes longer than cap, truncated by a finalize pass
//   (countstep.py:947-958): writes here stop at cap and the true
//   new_size is reported, so the caller's one-step-late replay grows the
//   table and re-runs the fold;
// - a second realness test and tie rule for wide keys
//   (pallas_merge.py:273-276): the sign flip makes them ordinary int64;
// - the JOIN's cnt+1 value plane, its invalid-key encoding (...FFFD) and
//   plookup_post's restore sort;
// - the x64 flag flips, the 1024-aligned pending-block DMA and the
//   smoke gates of the TPU toolchain.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (yak_tpu_torch/ops/cuda_build.py); bound with
//        ctypes (yak_tpu_torch/ops/merge.py).

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                 // threads a block
constexpr int WARPS = NT / 32;
constexpr int IPT = 16;                 // merged lanes a thread
constexpr int TILE = NT * IPT;          // merged lanes a tile: 4096
constexpr int PAD = 16;                 // lanes the 16-byte rounding adds
constexpr long long KINF = 0x7fffffffffffffffLL;
constexpr unsigned MAX_COUNT = 1023;
constexpr unsigned SAT = 1u << 30;      // run sums saturate here
constexpr unsigned FULL = 0xffffffffu;
constexpr int PART_LANES = 8;           // partition probes a step

// a partition word: the table lanes before the tile edge, and the flag
// of a tile whose first lane is invalid (or that starts past the stream)
constexpr unsigned long long P_TAIL = 1ULL << 62;
constexpr unsigned long long P_MASK = P_TAIL - 1;

// a status word: flag in the top two bits, value below
constexpr unsigned long long ST_AGG = 1ULL << 62;   // the tile's own value
constexpr unsigned long long ST_INC = 1ULL << 63;   // tiles 0..t's value
constexpr unsigned long long ST_VAL = ST_AGG - 1;

// A segmented-scan element in one word: s (the sum since the last run
// head, saturated at SAT) in bits 0-30, p (table presence since the last
// head) in bit 31, f (a head lies inside) in bit 32.  0 is the identity.
constexpr unsigned long long SEG_S = 0x7fffffffULL;
constexpr unsigned long long SEG_P = 1ULL << 31;
constexpr unsigned long long SEG_F = 1ULL << 32;

__device__ __forceinline__ unsigned sat_add(unsigned a, unsigned b) {
    return min(a + b, SAT);             // a, b <= 2^30: no wrap
}

// a then b (a earlier): b's head fixes s and p
__device__ __forceinline__ unsigned long long seg_combine(
    unsigned long long a, unsigned long long b) {
    if (b & SEG_F) return b;
    return (a & (SEG_F | SEG_P)) | (b & SEG_P)
           | sat_add((unsigned)(a & SEG_S), (unsigned)(b & SEG_S));
}

__device__ __forceinline__ unsigned long long seg_lane(bool head, unsigned v,
                                                       bool tab) {
    return (head ? SEG_F : 0) | (tab ? SEG_P : 0) | min(v, SAT);
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
    return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
    *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ long long live_size(const int* size_ptr,
                                               long long cap) {
    const long long s = *size_ptr;
    return s < 0 ? 0 : (s > cap ? cap : s);
}

// Whether a run that ends survives: with weights, a run absent from the
// table is created only when its weight sum is above 0.
template <bool WEIGHTED>
__device__ __forceinline__ bool keep_run(int create, bool pres, unsigned s) {
    if constexpr (WEIGHTED) return create ? (pres || s > 0) : pres;
    return create || pres;
}

struct Stage {
    long long key[TILE + PAD];   // table slice, then batch slice
    int val[TILE + PAD];         // table counts, then weights or qidx
};

struct Smem {
    Stage stage[2];
    unsigned long long wseg[WARPS];
    unsigned wcnt[WARPS];
    unsigned long long ce;       // the continued run's end lane: (s, p)
    long long ce_key;
    long long off;               // the tile's first output lane
    unsigned claim[2];           // tile IDs claimed, by stage
    int has_ce, ce_keep, ce_val;
};

// One tile: its lanes of each stream and where they sit in its stage.
struct Tile {
    long long t, a0, b0;
    int na, nbt;
    bool live, tail;
    bool pa, pb;       // the table / batch lane before the slice exists
    bool xa, xb;       // the table / batch lane after the slice exists
    int ka, kb;        // key[] lane of table lane a0 / batch lane b0
    int ca, cb;        // val[] lane of table lane a0 / batch lane b0
};

__device__ __forceinline__ Tile describe(long long t, long long ntiles,
                                         const long long* part,
                                         long long size, long long nbatch) {
    Tile d{};
    d.t = t;
    const long long N = size + nbatch;
    d.live = t < ntiles && t * TILE < N;
    if (!d.live) return d;
    const unsigned long long p0 = part[t], p1 = part[t + 1];
    d.tail = (p0 & P_TAIL) != 0;
    d.a0 = (long long)(p0 & P_MASK);
    const long long a1 = (long long)(p1 & P_MASK);
    const long long d0 = t * TILE, d1 = min(d0 + TILE, N);
    d.b0 = d0 - d.a0;
    const long long b1 = d1 - a1;
    d.na = (int)(a1 - d.a0);
    d.nbt = (int)(b1 - d.b0);
    d.pa = d.a0 > 0;
    d.pb = d.b0 > 0;
    d.xa = a1 < size;
    d.xb = b1 < nbatch;
    return d;
}

// Starts the copies of g[lo, hi), rounded out to whole 16-byte segments,
// to the shared bytes dst + used (16-byte aligned) and advances used;
// returns the lane of g[lo] counted from dst.
template <typename T>
__device__ __forceinline__ int copy_slice(unsigned char* dst, int& used,
                                          const T* g, long long lo,
                                          long long hi) {
    const int at = used / (int)sizeof(T);
    if (hi <= lo) return at;
    const uintptr_t a = (uintptr_t)(g + lo), e = (uintptr_t)(g + hi);
    const uintptr_t a16 = a & ~(uintptr_t)15;
    const int chunks = (int)((((e + 15) & ~(uintptr_t)15) - a16) >> 4);
    for (int c = threadIdx.x; c < chunks; c += NT)
        cp_async16(dst + used + 16 * c, (const void*)(a16 + 16 * (uintptr_t)c));
    used += 16 * chunks;
    return at + (int)((a - a16) / sizeof(T));
}

// Starts loading tile d into stage st: the table keys with the lane on
// each side, the table counts with the lane before, the batch keys with
// the lane on each side and, with a plane, the batch lanes' int32 values.
template <bool PLANE>
__device__ __forceinline__ void start_load(Stage& st, Tile& d,
                                           const long long* A,
                                           const int* Acnt,
                                           const long long* B,
                                           const int* Bp) {
    unsigned char* kbuf = reinterpret_cast<unsigned char*>(st.key);
    unsigned char* vbuf = reinterpret_cast<unsigned char*>(st.val);
    int ku = 0, vu = 0;
    const long long a1 = d.a0 + d.na, b1 = d.b0 + d.nbt;
    d.ka = copy_slice(kbuf, ku, A, d.a0 - d.pa, a1 + d.xa) + d.pa;
    d.kb = copy_slice(kbuf, ku, B, d.b0 - d.pb, b1 + d.xb) + d.pb;
    d.ca = copy_slice(vbuf, vu, Acnt, d.a0 - d.pa, a1) + d.pa;
    if (PLANE) d.cb = copy_slice(vbuf, vu, Bp, d.b0, b1);
}

// The split of diagonal diag of the tile's slices: table lanes among its
// first diag merged lanes (table first on equal keys).
__device__ __forceinline__ int merge_path(const long long* sa, int na,
                                          const long long* sb, int nbt,
                                          int diag) {
    int lo = max(0, diag - nbt), hi = min(diag, na);
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sa[mid] <= sb[diag - 1 - mid]) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// Exclusive sum over the block; *total gets the block's sum.  Every
// thread of the block calls it.
__device__ __forceinline__ unsigned block_sum_excl(unsigned v, unsigned* wsum,
                                                   unsigned* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    unsigned pre = 0, all = 0;
    for (int w = 0; w < WARPS; ++w) {
        if (w < warp) pre += wsum[w];
        all += wsum[w];
    }
    *total = all;
    return pre + x - v;
}

// Decoupled look-back by one warp: the value of tiles 0..t-1 from their
// status words, 32 a step (lane l reads tile j - l), each step waiting
// until every word up to the nearest inclusive one is published.  SEG:
// segmented aggregates, combined earlier (+) later; else counts, summed.
// (Steps of 128 or 256 words waited longer on the H100.)
template <bool SEG>
__device__ unsigned long long look_back(const unsigned long long* st,
                                        long long t) {
    const int lane = threadIdx.x & 31;
    unsigned long long acc = 0;
    for (long long j = t - 1;;) {
        const unsigned long long w =
            j - lane >= 0 ? load_status(&st[j - lane]) : 0;
        const unsigned inc = __ballot_sync(FULL, (w & ST_INC) != 0);
        const unsigned pub = __ballot_sync(FULL, w != 0);
        const int first = inc ? __ffs(inc) - 1 : 31;
        const unsigned need = first == 31 ? FULL : (2u << first) - 1;
        if ((pub & need) != need) continue;
        unsigned long long v = lane <= first ? (w & ST_VAL) : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned long long u = __shfl_down_sync(FULL, v, o);
            if (lane + o < 32) v = SEG ? seg_combine(u, v) : u + v;
        }
        v = __shfl_sync(FULL, v, 0);
        acc = SEG ? seg_combine(v, acc) : v + acc;
        if (inc) return acc;
        j -= 32;
    }
}

// PART_LANES lanes a tile edge t in [0, ntiles]: part[t] = the table
// lanes among the first min(t * TILE, N) merged lanes, | P_TAIL when the
// tile starting there has no valid first lane.  Each step the group's
// lanes probe the predicate A[m] <= B[d - 1 - m] (true below the split)
// at evenly spaced m; a group whose range is closed idles until the
// warp's last one closes.
__global__ void __launch_bounds__(256)
k_partition(const long long* __restrict__ A, const int* __restrict__ size_ptr,
            long long cap, const long long* __restrict__ B, long long nbatch,
            long long ntiles, unsigned long long* __restrict__ part) {
    const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long t = g / PART_LANES;
    const int gl = threadIdx.x % PART_LANES;
    const int shift = (threadIdx.x & 31) - gl;
    const long long size = live_size(size_ptr, cap);
    const long long N = size + nbatch;
    const long long d = min(t * TILE, N);
    long long lo = max(0LL, d - nbatch), hi = min(d, size);
    if (t > ntiles) lo = hi = 0;
    while (__any_sync(FULL, lo < hi)) {
        const bool open = lo < hi;
        const long long step = (hi - lo + PART_LANES - 1) / PART_LANES;
        const long long m = lo + (gl + 1) * step - 1;
        const bool below = open && m < hi && A[m] <= B[d - 1 - m];
        const long long c = __popc(
            (__ballot_sync(FULL, below) >> shift) & ((1u << PART_LANES) - 1));
        if (open) {
            hi = min(lo + (c + 1) * step - 1, hi);
            lo += c * step;
        }
    }
    if (gl == 0 && t <= ntiles) {
        const bool tail = d >= N || (lo == size && B[d - lo] == KINF);
        part[t] = (unsigned long long)lo | (tail ? P_TAIL : 0);
    }
}

// The merge-reduce (see the note at the top).  seg_st and cnt_st hold a
// status word a tile, zeroed before the launch with *ctr, *new_size and
// *n_new.
template <bool WEIGHTED>
__global__ void __launch_bounds__(NT, 2)
k_reduce(const long long* __restrict__ A, const int* __restrict__ Acnt,
         const int* __restrict__ size_ptr, long long cap,
         const long long* __restrict__ B, const int* __restrict__ Bw,
         long long nbatch, int create, long long ntiles,
         const long long* __restrict__ part, unsigned* __restrict__ ctr,
         unsigned long long* __restrict__ seg_st,
         unsigned long long* __restrict__ cnt_st, int* __restrict__ new_size,
         int* __restrict__ n_new, long long* __restrict__ okeys,
         int* __restrict__ ocnt) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long size = live_size(size_ptr, cap);

    if (tid == 0) sm.claim[0] = atomicAdd(ctr, 1u);
    __syncthreads();
    Tile cur = describe(sm.claim[0], ntiles, part, size, nbatch);
    if (!cur.live || cur.tail) return;
    start_load<WEIGHTED>(sm.stage[0], cur, A, Acnt, B, Bw);
    cp_async_commit();
    for (int s = 0;; s ^= 1) {
        // the claim for the other stage: its slot was last read before
        // the previous iteration's first barrier
        if (tid == 0) {
            sm.claim[s ^ 1] = atomicAdd(ctr, 1u);
            sm.has_ce = 0;
        }
        cp_async_wait_all();
        __syncthreads();
        const long long next_t = sm.claim[s ^ 1];
        const long long t = cur.t;
        Stage& st = sm.stage[s];
        const long long* sa = st.key + cur.ka;
        const long long* sb = st.key + cur.kb;
        const int* sc = st.val + cur.ca;
        const int* sw = st.val + cur.cb;
        const int na = cur.na, nbt = cur.nbt, n = na + nbt;

        // this thread's lanes of the merged tile, in registers
        const int diag = min(tid * IPT, n);
        const int cnt = min(IPT, n - diag);
        int ai = merge_path(sa, na, sb, nbt, diag), bi = diag - ai;
        // the merged lane before this thread's first (in the tile, or
        // the loaded lane before the tile); none at the stream's start
        bool has_prev;
        long long prev = 0;
        {
            const bool ha = ai > 0 || cur.pa, hb = bi > 0 || cur.pb;
            const long long pa = ha ? sa[ai - 1] : 0, pb = hb ? sb[bi - 1] : 0;
            has_prev = ha || hb;
            prev = !ha ? pb : !hb ? pa : max(pa, pb);
        }
        long long key[IPT];
        unsigned val[IPT];
        unsigned tabm = 0;
        {
            long long kA = ai < na ? sa[ai] : 0, kB = bi < nbt ? sb[bi] : 0;
#pragma unroll
            for (int q = 0; q < IPT; ++q) {
                key[q] = KINF;
                val[q] = 0;
                if (q < cnt) {
                    if (ai < na && (bi >= nbt || kA <= kB)) {
                        key[q] = kA;
                        val[q] = (unsigned)max(sc[ai], 0);
                        tabm |= 1u << q;
                        ++ai;
                        kA = ai < na ? sa[ai] : 0;
                    } else {
                        key[q] = kB;
                        val[q] = WEIGHTED ? (unsigned)sw[bi] : 1u;
                        ++bi;
                        kB = bi < nbt ? sb[bi] : 0;
                    }
                }
            }
        }
        // the merged lane after this thread's last: in the tile, or the
        // loaded lane after the tile; none at the stream's end
        bool has_next;
        long long next = 0;
        {
            const bool ina = ai < na, inb = bi < nbt;
            if (diag + cnt < n) {
                has_next = true;
                next = ina && (!inb || sa[ai] <= sb[bi]) ? sa[ai] : sb[bi];
            } else {
                const long long xa = cur.xa ? sa[na] : 0;
                const long long xb = cur.xb ? sb[nbt] : 0;
                has_next = cur.xa || cur.xb;
                next = cur.xa && (!cur.xb || xa <= xb) ? xa : xb;
            }
        }

        // prefetch the next tile into the other stage
        Tile nxt = describe(next_t, ntiles, part, size, nbatch);
        nxt.live = nxt.live && !nxt.tail;
        if (nxt.live)
            start_load<WEIGHTED>(sm.stage[s ^ 1], nxt, A, Acnt, B, Bw);
        cp_async_commit();

        // run edges and the thread's segmented scan
        unsigned validm = 0, endm = 0, seenm = 0, presm = 0;
        unsigned sv[IPT];
        unsigned long long agg = 0;
#pragma unroll
        for (int q = 0; q < IPT; ++q) {
            sv[q] = 0;
            if (q >= cnt || key[q] == KINF) continue;
            validm |= 1u << q;
            const bool head = q == 0 ? (!has_prev || prev != key[0])
                                     : key[q - 1] != key[q];
            const bool end = q + 1 < cnt ? key[q + 1] != key[q]
                                         : (!has_next || next != key[q]);
            if (end) endm |= 1u << q;
            agg = seg_combine(agg, seg_lane(head, val[q], (tabm >> q) & 1));
            sv[q] = (unsigned)(agg & SEG_S);
            if (agg & SEG_P) presm |= 1u << q;
            if (agg & SEG_F) seenm |= 1u << q;
        }

        // block scan of the segmented aggregates
        unsigned long long x = agg;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned long long y = __shfl_up_sync(FULL, x, o);
            if (lane >= o) x = seg_combine(y, x);
        }
        unsigned long long ex = __shfl_up_sync(FULL, x, 1);
        if (lane == 0) ex = 0;
        if (lane == 31) sm.wseg[warp] = x;
        __syncthreads();
        unsigned long long pre = 0, tot = 0;
        for (int w = 0; w < WARPS; ++w) {
            if (w == warp) pre = tot;
            tot = seg_combine(tot, sm.wseg[w]);
        }
        ex = seg_combine(pre, ex);
        // (a) the aggregate before any wait; a head makes it inclusive
        if (tid == 0)
            store_status(&seg_st[t],
                         (t == 0 || (tot & SEG_F) ? ST_INC : ST_AGG) | tot);

        // each lane's run sum and presence in the tile; the lanes of the
        // run continued from earlier tiles still lack its carry
        unsigned keptm = 0, created = 0;
#pragma unroll
        for (int q = 0; q < IPT; ++q) {
            if (!((validm >> q) & 1)) continue;
            bool pres = (presm >> q) & 1;
            if (!((seenm >> q) & 1)) {
                sv[q] = sat_add((unsigned)(ex & SEG_S), sv[q]);
                pres = pres || (ex & SEG_P);
                if (pres) presm |= 1u << q;
            }
            if (!((endm >> q) & 1)) continue;
            if (!((seenm >> q) & 1) && !(ex & SEG_F)) {
                // the end of the continued run: its presence and sum
                // come with the carry
                sm.ce = (pres ? SEG_P : 0) | sv[q];
                sm.ce_key = key[q];
                sm.has_ce = 1;
                endm &= ~(1u << q);
            } else if (keep_run<WEIGHTED>(create, pres, sv[q])) {
                keptm |= 1u << q;
                created += pres ? 0 : 1;
            }
        }
        unsigned ctot;
        const unsigned coff = block_sum_excl(
            __popc(keptm) | (created << 16), sm.wcnt, &ctot);

        // warp 0: the carry and the continued run's fate; the survivor
        // offset by warp 1 at the same time when no carry can change the
        // count, else by warp 0 after the carry
        const bool has_ce = sm.has_ce != 0;
        const bool early = !has_ce || (create && !WEIGHTED);
        const unsigned kept = ctot & 0xffffu;
        if (warp == 0) {
            unsigned long long carry = 0;
            if (t > 0 && (has_ce || !(tot & SEG_F))) {
                carry = look_back<true>(seg_st, t);
                if (!(tot & SEG_F) && lane == 0)
                    store_status(&seg_st[t], ST_INC | seg_combine(carry, tot));
            }
            int ce_keep = 0;
            unsigned ce_s = 0, made = ctot >> 16;
            if (has_ce) {
                const unsigned long long ce = seg_combine(carry, sm.ce);
                ce_s = (unsigned)(ce & SEG_S);
                const bool p = (ce & SEG_P) != 0;
                ce_keep = keep_run<WEIGHTED>(create, p, ce_s);
                made += ce_keep && !p ? 1 : 0;
            }
            if (!early) {
                // t > 0: tile 0 continues no run
                const unsigned count = kept + ce_keep;
                if (lane == 0) store_status(&cnt_st[t], ST_AGG | count);
                const unsigned long long off = look_back<false>(cnt_st, t);
                if (lane == 0) {
                    store_status(&cnt_st[t], ST_INC | (off + count));
                    if (count) atomicAdd(new_size, (int)count);
                    sm.off = (long long)off;
                }
            }
            if (lane == 0) {
                if (made) atomicAdd(n_new, (int)made);
                sm.ce_keep = ce_keep;
                sm.ce_val = (int)min(ce_s, MAX_COUNT);
            }
        } else if (warp == 1 && early) {
            const unsigned count = kept + (has_ce ? 1 : 0);
            if (lane == 0)
                store_status(&cnt_st[t], (t == 0 ? ST_INC : ST_AGG) | count);
            const unsigned long long off =
                t > 0 ? look_back<false>(cnt_st, t) : 0;
            if (lane == 0) {
                if (t > 0) store_status(&cnt_st[t], ST_INC | (off + count));
                if (count) atomicAdd(new_size, (int)count);
                sm.off = (long long)off;
            }
        }
        __syncthreads();

        // stage the survivors in output order in this tile's stage
        const int first = sm.ce_keep;
        if (tid == 0 && first) {
            st.key[0] = sm.ce_key;
            st.val[0] = sm.ce_val;
        }
        {
            int o = first + (int)(coff & 0xffffu);
#pragma unroll
            for (int q = 0; q < IPT; ++q) {
                if (!((keptm >> q) & 1)) continue;
                st.key[o] = key[q];
                st.val[o] = (int)min(sv[q], MAX_COUNT);
                ++o;
            }
        }
        __syncthreads();
        const long long off = sm.off;
        const int total = first + (int)(ctot & 0xffffu);
        for (int i = tid; i < total && off + i < cap; i += NT) {
            okeys[off + i] = st.key[i];
            ocnt[off + i] = st.val[i];
        }
        if (!nxt.live) break;
        cur = nxt;
    }
}

// The JOIN (see the note at the top).  *ctr is zeroed before the launch.
__global__ void __launch_bounds__(NT, 2)
k_join(const long long* __restrict__ A, const int* __restrict__ Acnt,
       const int* __restrict__ size_ptr, long long cap,
       const long long* __restrict__ B, const int* __restrict__ qidx,
       long long nbatch, long long ntiles, const long long* __restrict__ part,
       unsigned* __restrict__ ctr, int* __restrict__ vals) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
    const int tid = threadIdx.x;
    const long long size = live_size(size_ptr, cap);

    if (tid == 0) sm.claim[0] = atomicAdd(ctr, 1u);
    __syncthreads();
    Tile cur = describe(sm.claim[0], ntiles, part, size, nbatch);
    if (!cur.live) return;
    if (!cur.tail) start_load<true>(sm.stage[0], cur, A, Acnt, B, qidx);
    cp_async_commit();
    for (int s = 0;; s ^= 1) {
        if (tid == 0) sm.claim[s ^ 1] = atomicAdd(ctr, 1u);
        cp_async_wait_all();
        __syncthreads();
        Tile nxt = describe(sm.claim[s ^ 1], ntiles, part, size, nbatch);
        if (nxt.live && !nxt.tail)
            start_load<true>(sm.stage[s ^ 1], nxt, A, Acnt, B, qidx);
        cp_async_commit();

        if (cur.tail) {
            // INT64_MAX queries only
            for (long long j = cur.b0 + tid; j < cur.b0 + cur.nbt; j += NT)
                vals[qidx[j]] = -1;
        } else {
            const Stage& st = sm.stage[s];
            const long long* sa = st.key + cur.ka;
            const long long* sb = st.key + cur.kb;
            const int* sc = st.val + cur.ca;
            const int* sq = st.val + cur.cb;
            const int na = cur.na, nbt = cur.nbt, n = na + nbt;
            const int diag = min(tid * IPT, n);
            const int cnt = min(IPT, n - diag);
            int ai = merge_path(sa, na, sb, nbt, diag), bi = diag - ai;
            // the last table lane before this thread's first lane
            bool has = ai > 0 || cur.pa;
            long long tk = has ? sa[ai - 1] : 0;
            int tc = has ? sc[ai - 1] : -1;
#pragma unroll
            for (int q = 0; q < IPT; ++q) {
                if (q >= cnt) break;
                if (ai < na && (bi >= nbt || sa[ai] <= sb[bi])) {
                    tk = sa[ai];
                    tc = sc[ai];
                    has = true;
                    ++ai;
                } else {
                    vals[sq[bi]] = has && tk == sb[bi] ? tc : -1;
                    ++bi;
                }
            }
        }
        if (!nxt.live) break;
        cur = nxt;
    }
}

// Launch geometry of a persistent kernel: one resident wave of blocks.
template <typename K>
int persistent_grid(K kernel, long long ntiles, unsigned* grid) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(Smem));
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                          sizeof(Smem));
    if (e != cudaSuccess) return (int)e;
    *grid = (unsigned)std::min(ntiles, (long long)std::max(per_sm, 1) * sms);
    return 0;
}

// The launch of k_partition for tile edges 0..ntiles.
int partition(const long long* tkeys, const int* size, long long cap,
              const long long* bkeys, long long nbatch, long long ntiles,
              unsigned long long* part, cudaStream_t s) {
    const long long threads = PART_LANES * (ntiles + 1);
    k_partition<<<(unsigned)((threads + 255) / 256), 256, 0, s>>>(
        tkeys, size, cap, bkeys, nbatch, ntiles, part);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int yak_merge_reduce_tile(void) { return TILE; }

const char* yak_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 8-byte words of scratch a call with ntiles tiles takes (join: the
// JOIN's).  The layout: word 0 holds the tile counter (low half) and
// new_size (high half), word 1 n_new (low half); then, for the
// merge-reduce only, the status words seg_st[ntiles] and cnt_st[ntiles];
// then part[ntiles + 1].
long long yak_merge_scratch_words(long long ntiles, int join) {
    return 2 + (join ? 0 : 2 * ntiles) + ntiles + 1;
}

// Lookup mode.  ntiles = ceil((cap + nbatch) / TILE) >= 1; scratch holds
// yak_merge_scratch_words(ntiles, 1) words.  Returns the first CUDA error
// (0 = none).
int yak_merge_join(const long long* tkeys, const int* tcnt, const int* size,
                   long long cap, const long long* qkeys, const int* qidx,
                   long long nbatch, long long ntiles, long long* scratch,
                   int* vals, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    unsigned* head = reinterpret_cast<unsigned*>(scratch);
    auto* part = reinterpret_cast<unsigned long long*>(scratch + 2);
    unsigned grid = 0;
    int e = persistent_grid(k_join, ntiles, &grid);
    if (e) return e;
    e = (int)cudaMemsetAsync(scratch, 0, 2 * sizeof(long long), s);
    if (e) return e;
    e = partition(tkeys, size, cap, qkeys, nbatch, ntiles, part, s);
    if (e) return e;
    k_join<<<grid, NT, sizeof(Smem), s>>>(
        tkeys, tcnt, size, cap, qkeys, qidx, nbatch, ntiles,
        reinterpret_cast<const long long*>(part), head, vals);
    return (int)cudaGetLastError();
}

// ntiles = ceil((cap + nbatch) / TILE) >= 1; scratch holds
// yak_merge_scratch_words(ntiles, 0) words; new_size and n_new are the
// int32 halves 1 and 2 of its first words (see
// yak_merge_scratch_words).  bweights:
// one int32 weight >= 0 per batch lane, or null for unit weights (count
// mode; wide keys take the same instantiation).  Returns the first CUDA
// error of the launches (0 = none).
int yak_merge_reduce(const long long* tkeys, const int* tcnt,
                     const int* size, long long cap, const long long* bkeys,
                     const int* bweights, long long nbatch, int create,
                     long long ntiles, long long* scratch, long long* okeys,
                     int* ocnt, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    unsigned* head = reinterpret_cast<unsigned*>(scratch);
    int* new_size = reinterpret_cast<int*>(scratch) + 1;
    int* n_new = reinterpret_cast<int*>(scratch) + 2;
    auto* seg_st = reinterpret_cast<unsigned long long*>(scratch + 2);
    unsigned long long* cnt_st = seg_st + ntiles;
    unsigned long long* part = cnt_st + ntiles;
    const auto kernel = bweights ? k_reduce<true> : k_reduce<false>;
    unsigned grid = 0;
    int e = persistent_grid(kernel, ntiles, &grid);
    if (e) return e;
    e = (int)cudaMemsetAsync(scratch, 0, (2 + 2 * ntiles) * sizeof(long long),
                             s);
    if (e) return e;
    e = partition(tkeys, size, cap, bkeys, nbatch, ntiles, part, s);
    if (e) return e;
    kernel<<<grid, NT, sizeof(Smem), s>>>(
        tkeys, tcnt, size, cap, bkeys, bweights, nbatch, create, ntiles,
        reinterpret_cast<const long long*>(part), head, seg_st, cnt_st,
        new_size, n_new, okeys, ocnt);
    return (int)cudaGetLastError();
}

}  // extern "C"
