// Ascending batch sort of the psort engine, written for Hopper (sm_90a):
// a stable least-significant-digit radix sort with one-sweep passes.
//
// Replaces the five Pallas programs of the TPU bitonic sort
// (yak_tpu/ops/pallas_sort.py, reached through sort_planes and
// sort_planes32 :737-771): _loop_kernel (:250), _exchange_kernel_dyn
// (:167), _tail_kernel_dyn (:204), _windowed_kernel (:107) and
// _exchange_kernel (:134).  The TPU has five only because of its
// compiler's costs (the LOOP/DYN/FUSE modes); they compute one function,
// and so does this source, in four instantiations:
//
//   keys int64 or int32 [n], compared as signed; an optional int32
//   payload [n] rides along.  Out: the lanes in ascending lexicographic
//   order of (key, payload).
//
// The TPU network leaves the order of equal keys unspecified; ordering
// ties by the payload is one valid refinement of it, and makes the
// result a function of the input alone, equal bit for bit to the plain
// torch version (two stable sorts) in yak_tpu_torch/ops/sort.py.
//
// What bounds it on the H100: device-memory bytes.  Each active pass
// reads and writes every lane once (16 B a lane with an int64 key, 24 B
// with a payload), and the histogram sweep reads the input once more,
// so the traffic is n x lane bytes x (2 x active passes + 1).  The
// design keeps the number of passes down and moves each lane once a
// pass; the lower bound, one read of the input and one write of the
// output, is what a single pass would cost.
//
// Design (after Onesweep: Adinets and Merrill, arXiv 2206.01784):
//
//   1. Digits are the 8-bit bytes of the key (8 or 4) and, with a
//      payload, of the payload (4 more).  The top byte of each has its
//      sign bit flipped as the digit is taken, so that digit order is
//      signed order; the lanes themselves are never changed, so the
//      input is read as it is and the output needs no flip back.
//   2. k_upsweep reads the input once and builds every digit's 256-bin
//      histogram (shared-memory bins per block, then global atomics; a
//      warp whose lanes share a digit adds them with one atomic).  With
//      a payload it also sets a flag when the payload is not
//      nondecreasing in input order.
//   3. k_plan (one block) reads the histograms on the device.  A digit
//      whose one bin holds all n lanes is constant: a stable pass over it
//      is the identity, so it is skipped.  When the payload is
//      nondecreasing in input order, a stable sort by key alone already
//      gives (key, payload) order, so the payload passes go (the qv and
//      chkerr query sorts, whose payload is the lane iota); else the
//      payload's varying digits come first, then the key's.  The plan
//      lists the active passes, each digit's exclusive bucket bases and
//      each pass's source and destination planes (input, alternate,
//      output), chosen so that the last active pass writes the output.
//      No active pass (n = 1, or all lanes equal) becomes one copy,
//      k_copy, which does nothing otherwise.
//   4. No host read-back: every possible pass kernel is launched (8 or 4
//      key passes, 4 more with a payload); one whose slot the plan left
//      empty reads its plan word and returns.
//   5. k_pass, one launch a pass: tiles of NT threads x ITEMS lanes in
//      registers, tile IDs from an atomic counter (so a tile only ever
//      waits on tiles already running).  Each warp ranks its lanes
//      stably, item by item, with __match_any_sync and per-warp bucket
//      counters in shared memory; a scan across warps and buckets gives
//      each lane's place in the tile in digit order.  Thread b of the
//      block publishes the tile's count of bucket b and finds the count
//      of bucket b in all earlier tiles by a decoupled look-back over
//      per-(tile, bucket) status words (flag + count in one 64-bit word,
//      so one store publishes both).  The tile is staged in shared
//      memory in digit order and written out with each bucket's lanes
//      contiguous.  Two status arrays alternate between passes; each
//      tile zeroes its row of the next pass's array.
//
// Index math is 64-bit; any n >= 1 is sorted as it is, without padding.
// The caller allocates everything: the n-lane outputs, an n-lane
// alternate pair and the scratch of yak_sort_scratch_bytes(n) (plan,
// histograms, flag, status words).
//
// What the TPU kernels needed and these do not: the hi/lo u32 split of
// 64-bit keys, neg_keys (the port's merge takes ascending keys), the x64
// flag flips, the VMEM option, the roll tricks, and the power-of-two
// length rule.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (yak_tpu_torch/ops/cuda_build.py); bound with
//        ctypes (yak_tpu_torch/ops/sort.py).

#include <algorithm>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                 // threads of the pass kernel
constexpr int WARPS = NT / 32;
constexpr int ITEMS = 15;               // lanes a thread holds
constexpr int TILE = NT * ITEMS;        // lanes a tile: 3840
constexpr int RADIX = 256;              // buckets of an 8-bit digit
constexpr int MAXP = 12;                // 8 key digits + 4 payload digits
constexpr int UNT = 256;                // threads of the histogram sweep
constexpr int UIT = 4;                  // lanes a sweep thread reads a step
constexpr int LOOK = 8;                 // status words a look-back step reads
constexpr unsigned FULL = 0xffffffffu;

// a (tile, bucket) status word: flag in the top two bits, count below
constexpr unsigned long long ST_AGG = 1ULL << 62;   // the tile's count
constexpr unsigned long long ST_INC = 1ULL << 63;   // tiles 0..t's count
constexpr unsigned long long ST_VAL = (1ULL << 62) - 1;

enum { BUF_IN = 0, BUF_ALT = 1, BUF_OUT = 2 };

struct Plan {
    int n_active;                     // active passes: slots 0..n_active-1
    int digit[MAXP];                  // each slot's digit (see digit())
    int src[MAXP];                    // each slot's planes: BUF_*
    int dst[MAXP];
    unsigned tile_ctr[MAXP];          // tile IDs handed out in each slot
    unsigned long long base[MAXP][RADIX];   // each digit's bucket bases
};

// Digit p of lane (k, v): key byte p for p < sizeof(K), else payload byte
// p - sizeof(K); the top byte of each has its sign bit flipped, so that
// unsigned digit order is signed order.
template <typename K>
__device__ __forceinline__ unsigned digit(K k, int v, int p) {
    constexpr int KD = sizeof(K);
    if (p < KD) {
        const unsigned d =
            (unsigned)((unsigned long long)k >> (8 * p)) & 0xFFu;
        return p == KD - 1 ? d ^ 0x80u : d;
    }
    const unsigned d = ((unsigned)v >> (8 * (p - KD))) & 0xFFu;
    return p == KD + 3 ? d ^ 0x80u : d;
}

// Exclusive prefix sum of v over the NT threads of the block in thread
// order; wsum holds WARPS values.  Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* wsum) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    T x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const T y = __shfl_up_sync(FULL, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    T pre = 0;
    for (int w = 0; w < warp; ++w) pre += wsum[w];
    __syncthreads();
    return pre + x - v;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
    return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
    *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// The histograms of the n input lanes into hist[P][RADIX] (zeroed by
// the caller): the key digits' and, with a payload, *unsorted = 1 when
// the payload decreases somewhere in input order; or (PAY_DIGITS) the
// payload digits', only when *unsorted says that their passes run.
// A warp reads UIT x 32 consecutive lanes a step.
template <typename K, bool PAY, bool PAY_DIGITS>
__global__ void __launch_bounds__(UNT)
k_upsweep(const K* __restrict__ in_k, const int* __restrict__ in_p,
          long long n, unsigned long long* __restrict__ hist,
          int* __restrict__ unsorted) {
    constexpr int KD = sizeof(K);
    constexpr int P0 = PAY_DIGITS ? KD : 0;
    constexpr int ND = PAY_DIGITS ? 4 : KD;
    if (PAY_DIGITS && *unsorted == 0) return;
    __shared__ unsigned sh[ND * RADIX];
    __shared__ int s_unsorted;
    for (int i = threadIdx.x; i < ND * RADIX; i += UNT) sh[i] = 0;
    if (threadIdx.x == 0) s_unsorted = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * UNT * UIT;
    for (long long b = ((long long)blockIdx.x * UNT + (threadIdx.x - lane)) * UIT;
         b < n; b += stride) {
        K k[UIT];
        int v[UIT];
#pragma unroll
        for (int u = 0; u < UIT; ++u) {
            const long long i = b + 32 * u + lane;
            k[u] = (!PAY_DIGITS && i < n) ? in_k[i] : K(0);
            v[u] = (PAY && i < n) ? in_p[i] : 0;
        }
#pragma unroll
        for (int u = 0; u < UIT; ++u) {
            const long long i = b + 32 * u + lane;
            const bool valid = i < n;
            const unsigned nvalid = __popc(__ballot_sync(FULL, valid));
#pragma unroll
            for (int q = 0; q < ND; ++q) {
                const unsigned d = digit<K>(k[u], v[u], P0 + q);
                const unsigned d0 = __shfl_sync(FULL, d, 0);
                if (__all_sync(FULL, !valid || d == d0)) {
                    if (lane == 0 && nvalid)
                        atomicAdd(&sh[q * RADIX + d0], nvalid);
                } else if (valid) {
                    atomicAdd(&sh[q * RADIX + d], 1u);
                }
            }
            if (PAY && !PAY_DIGITS) {
                int next = __shfl_down_sync(FULL, v[u], 1);
                if (lane == 31 && i + 1 < n) next = in_p[i + 1];
                if (valid && i + 1 < n && v[u] > next) s_unsorted = 1;
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < ND * RADIX; i += UNT)
        if (sh[i]) atomicAdd(&hist[P0 * RADIX + i], (unsigned long long)sh[i]);
    if (PAY && !PAY_DIGITS && threadIdx.x == 0 && s_unsorted) *unsorted = 1;
}

// The plan (one block of NT threads, warp w scanning digits w, w + WARPS,
// ...): the bucket bases of every digit, the active passes in order and
// their planes, the tile counters zeroed; the number of active passes
// also to *passes.
template <int KD, bool PAY>
__global__ void __launch_bounds__(NT)
k_plan(const unsigned long long* __restrict__ hist,
       const int* __restrict__ unsorted, long long n,
       Plan* __restrict__ plan, int* __restrict__ passes) {
    constexpr int P = KD + (PAY ? 4 : 0);
    constexpr int PER = RADIX / 32;     // bins a lane scans
    __shared__ int constant[MAXP];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int p = warp; p < P; p += WARPS) {
        unsigned long long c[PER], sum = 0;
        bool all = false;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
            c[j] = hist[p * RADIX + lane * PER + j];
            sum += c[j];
            all |= c[j] == (unsigned long long)n;
        }
        unsigned long long x = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned long long y = __shfl_up_sync(FULL, x, o);
            if (lane >= o) x += y;
        }
        unsigned long long base = x - sum;
#pragma unroll
        for (int j = 0; j < PER; ++j) {
            plan->base[p][lane * PER + j] = base;
            base += c[j];
        }
        const bool cst = __any_sync(FULL, all);
        if (lane == 0) constant[p] = cst;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    int order[MAXP];
    int a = 0;
    if (PAY && *unsorted)
        for (int p = KD; p < P; ++p)
            if (!constant[p]) order[a++] = p;
    for (int p = 0; p < KD; ++p)
        if (!constant[p]) order[a++] = p;
    int prev = BUF_IN;
    for (int j = 0; j < MAXP; ++j) {
        plan->tile_ctr[j] = 0;
        if (j < a) {
            // the last active pass writes the output, the one before it
            // the alternate planes, and so on back to the first
            const int dst = ((a - 1 - j) & 1) ? BUF_ALT : BUF_OUT;
            plan->digit[j] = order[j];
            plan->src[j] = prev;
            plan->dst[j] = dst;
            prev = dst;
        }
    }
    plan->n_active = a;
    *passes = a;
}

// The input to the output when the plan has no active pass.
template <typename K, bool PAY>
__global__ void __launch_bounds__(NT)
k_copy(const Plan* __restrict__ plan, const K* __restrict__ in_k,
       const int* __restrict__ in_p, long long n, K* __restrict__ out_k,
       int* __restrict__ out_p) {
    if (plan->n_active != 0) return;
    const long long stride = (long long)gridDim.x * NT;
    for (long long i = (long long)blockIdx.x * NT + threadIdx.x; i < n;
         i += stride) {
        out_k[i] = in_k[i];
        if (PAY) out_p[i] = in_p[i];
    }
}

// Load tile `tile`'s keys (and, with `with_pay`, its payload) into a
// thread's registers: warp w holds lanes [w * 32 * ITEMS, (w + 1) * 32 *
// ITEMS) of the tile, item i of lane l at i * 32 + l (coalesced).
template <typename K>
__device__ __forceinline__ void load_tile(const K* src_k, const int* src_p,
                                          bool with_pay, long long tile,
                                          long long n, K (&keys)[ITEMS],
                                          int (&pays)[ITEMS]) {
    const long long wbase = tile * TILE
                            + (long long)(threadIdx.x >> 5) * 32 * ITEMS
                            + (threadIdx.x & 31);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
        const long long j = wbase + 32LL * i;
        keys[i] = j < n ? src_k[j] : K(0);
        pays[i] = (with_pay && j < n) ? src_p[j] : 0;
    }
}

// The pass of the plan's slot `slot`: a stable scatter of the source
// planes by the slot's digit into the destination planes.  The slot runs
// in the instantiation whose PAY_DIGIT says whether its digit is a
// payload byte; the other one returns, as both do for an empty slot.
// Each block takes tiles from the slot's counter until none is left,
// loading the next tile's keys while it finishes the current one.
// status holds two arrays of tiles x RADIX words: the slot uses array
// slot & 1 and zeroes each tile's row of the other.
template <typename K, bool PAY, bool PAY_DIGIT>
__global__ void __launch_bounds__(NT, PAY ? 2 : 3)
k_pass(int slot, const K* in_k, const int* in_p, K* alt_k, int* alt_p,
       K* out_k, int* out_p, long long n, Plan* __restrict__ plan,
       unsigned long long* __restrict__ status, long long tiles) {
    constexpr int KD = sizeof(K);
    if (slot >= plan->n_active) return;
    const int p = plan->digit[slot];
    if ((p >= KD) != PAY_DIGIT) return;
    extern __shared__ __align__(16) unsigned char smem[];
    long long* dst_off = reinterpret_cast<long long*>(smem);    // [RADIX]
    K* sk = reinterpret_cast<K*>(dst_off + RADIX);              // [TILE]
    unsigned* wcnt = reinterpret_cast<unsigned*>(sk + TILE);    // [WARPS][RADIX]
    int* sp = reinterpret_cast<int*>(wcnt + WARPS * RADIX);     // [TILE]
    __shared__ unsigned wsum[WARPS];
    __shared__ long long s_tile[2];

    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int src = plan->src[slot], dst = plan->dst[slot];
    const K* src_k = src == BUF_IN ? in_k : src == BUF_ALT ? alt_k : out_k;
    const int* src_p = src == BUF_IN ? in_p : src == BUF_ALT ? alt_p : out_p;
    K* dst_k = dst == BUF_ALT ? alt_k : out_k;
    int* dst_p = dst == BUF_ALT ? alt_p : out_p;
    unsigned long long* st = status + (long long)(slot & 1) * tiles * RADIX;
    unsigned long long* st_next =
        status + (long long)((slot + 1) & 1) * tiles * RADIX;
    unsigned* ctr = &plan->tile_ctr[slot];
    const unsigned le = FULL >> (31 - lane);
    K keys[ITEMS];
    int pays[ITEMS];
    unsigned pos[ITEMS];

    if (t == 0) s_tile[0] = atomicAdd(ctr, 1u);
    __syncthreads();
    long long tile = s_tile[0];
    if (tile < tiles) load_tile(src_k, src_p, PAY_DIGIT, tile, n, keys, pays);
    for (int nx = 1; tile < tiles; nx ^= 1) {
        if (t == 0) s_tile[nx] = atomicAdd(ctr, 1u);
        for (int i = t; i < WARPS * RADIX; i += NT) wcnt[i] = 0;
        st_next[tile * RADIX + t] = 0;
        __syncthreads();
        const long long next = s_tile[nx];
        const long long wbase = tile * TILE + (long long)warp * 32 * ITEMS + lane;
        const long long left = n - tile * TILE;

        // the tile's count of each digit, per warp (a warp whose lanes
        // share the digit adds them with one atomic)
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
            const bool valid = wbase + 32LL * i < n;
            const unsigned d = digit<K>(keys[i], pays[i], p);
            const unsigned d0 = __shfl_sync(FULL, d, 0);
            if (__all_sync(FULL, valid && d == d0)) {
                if (lane == 0) atomicAdd(&wcnt[warp * RADIX + d0], 32u);
            } else if (valid) {
                atomicAdd(&wcnt[warp * RADIX + d], 1u);
            }
        }
        __syncthreads();

        // thread t = bucket t: the tile's count published at once, so
        // that later tiles' look-backs need not wait for this tile's
        // ranking; each warp's first place for bucket t in the tile
        unsigned cnt = 0;
        for (int w = 0; w < WARPS; ++w) {
            const unsigned c = wcnt[w * RADIX + t];
            wcnt[w * RADIX + t] = cnt;
            cnt += c;
        }
        store_status(&st[tile * RADIX + t],
                     (tile == 0 ? ST_INC : ST_AGG) | cnt);
        const unsigned local_off = block_exclusive_scan(cnt, wsum);
        for (int w = 0; w < WARPS; ++w) wcnt[w * RADIX + t] += local_off;
        __syncthreads();

        // rank within the warp, stable (item by item in input order,
        // lanes of one digit in lane order, the group's highest lane
        // advancing the warp's counter), and stage the tile in shared
        // memory in digit order
#pragma unroll
        for (int i = 0; i < ITEMS; ++i) {
            const bool valid = wbase + 32LL * i < n;
            const unsigned d = digit<K>(keys[i], pays[i], p);
            const unsigned peers = __match_any_sync(FULL, valid ? d : RADIX);
            const int leader = 31 - __clz(peers);
            unsigned before = 0;
            if (lane == leader && valid) {
                before = wcnt[warp * RADIX + d];
                wcnt[warp * RADIX + d] = before + __popc(peers);
            }
            __syncwarp();
            pos[i] = __shfl_sync(FULL, before, leader) + __popc(peers & le) - 1;
            if (valid) {
                sk[pos[i]] = keys[i];
                if (PAY_DIGIT) sp[pos[i]] = pays[i];
            }
        }
        // a key pass's payload rides along: loaded now, while the
        // look-back runs, and staged at its key's place
        if (PAY && !PAY_DIGIT) {
#pragma unroll
            for (int i = 0; i < ITEMS; ++i) {
                const long long j = wbase + 32LL * i;
                pays[i] = j < n ? src_p[j] : 0;
            }
        }

        // decoupled look-back: bucket t's count in tiles 0..tile-1, from
        // the status words of LOOK earlier tiles at a time (read
        // together, added in order down to the first inclusive count; an
        // unpublished word is read again in the next step)
        unsigned long long prefix = 0;
        if (tile > 0) {
            for (long long j = tile - 1;;) {
                unsigned long long sw[LOOK];
#pragma unroll
                for (int w = 0; w < LOOK; ++w)
                    sw[w] = j - w >= 0 ? load_status(&st[(j - w) * RADIX + t])
                                       : 0;
                bool done = false;
                int w = 0;
                for (; w < LOOK && sw[w] != 0; ++w) {
                    prefix += sw[w] & ST_VAL;
                    if (sw[w] & ST_INC) {
                        done = true;
                        break;
                    }
                }
                if (done) break;
                j -= w;
            }
            store_status(&st[tile * RADIX + t], ST_INC | (prefix + cnt));
        }
        dst_off[t] =
            (long long)(plan->base[p][t] + prefix) - (long long)local_off;
        if (PAY && !PAY_DIGIT) {
#pragma unroll
            for (int i = 0; i < ITEMS; ++i)
                if (wbase + 32LL * i < n) sp[pos[i]] = pays[i];
        }
        __syncthreads();

        // the next tile's keys, in flight during the write-out
        if (next < tiles)
            load_tile(src_k, src_p, PAY_DIGIT, next, n, keys, pays);

        // write out: consecutive staged lanes of one bucket go to
        // consecutive places
        const int tn = left < TILE ? (int)left : TILE;
        for (int j = t; j < tn; j += NT) {
            const K k = sk[j];
            const int v = PAY ? sp[j] : 0;
            const long long g = dst_off[digit<K>(k, v, p)] + j;
            dst_k[g] = k;
            if (PAY) dst_p[g] = v;
        }
        tile = next;
    }
}

struct Layout {
    long long tiles;
    size_t hist, flag, status, total;   // byte offsets in the scratch
};

Layout layout(long long n) {
    Layout l;
    l.tiles = (n + TILE - 1) / TILE;
    l.hist = (sizeof(Plan) + 255) & ~size_t(255);
    l.flag = l.hist + sizeof(unsigned long long) * MAXP * RADIX;
    l.status = l.flag + 256;
    l.total = l.status + 2 * sizeof(unsigned long long) * RADIX * l.tiles;
    return l;
}

template <typename K, bool PAY>
int run(const K* in_k, const int* in_p, long long n, K* alt_k, int* alt_p,
        K* out_k, int* out_p, unsigned char* scratch, int* passes,
        cudaStream_t s) {
    constexpr int P = sizeof(K) + (PAY ? 4 : 0);
    const Layout l = layout(n);
    Plan* plan = reinterpret_cast<Plan*>(scratch);
    auto* hist = reinterpret_cast<unsigned long long*>(scratch + l.hist);
    int* unsorted = reinterpret_cast<int*>(scratch + l.flag);
    auto* status = reinterpret_cast<unsigned long long*>(scratch + l.status);
    const size_t smem = RADIX * sizeof(long long) + TILE * sizeof(K)
                        + WARPS * RADIX * sizeof(unsigned)
                        + (PAY ? TILE * sizeof(int) : 0);
    cudaError_t e = cudaFuncSetAttribute(
        k_pass<K, PAY, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(k_pass<K, PAY, PAY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    // the histograms, the order flag and the first pass's status words
    // start at 0
    e = cudaMemsetAsync(scratch + l.hist, 0,
                        l.status + sizeof(unsigned long long) * RADIX * l.tiles
                            - l.hist,
                        s);
    if (e != cudaSuccess) return (int)e;
    int dev = 0, sms = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const long long ublocks =
        std::min((n + UNT * UIT - 1) / (UNT * UIT), 4LL * sms);
    k_upsweep<K, PAY, false><<<(unsigned)ublocks, UNT, 0, s>>>(in_k, in_p, n, hist, unsorted);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (PAY) {
        k_upsweep<K, PAY, true><<<(unsigned)ublocks, UNT, 0, s>>>(in_k, in_p, n, hist, unsorted);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    k_plan<(int)sizeof(K), PAY><<<1, NT, 0, s>>>(hist, unsorted, n, plan, passes);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    k_copy<K, PAY><<<(unsigned)std::min(l.tiles, 1024LL), NT, 0, s>>>(plan, in_k, in_p, n, out_k, out_p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    // one resident wave of blocks a pass
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k_pass<K, PAY, false>, NT, smem);
    if (e != cudaSuccess) return (int)e;
    const unsigned pblocks =
        (unsigned)std::min(l.tiles, (long long)std::max(per_sm, 1) * sms);
    // a payload byte's pass can only take one of the first four slots
    for (int slot = 0; slot < P; ++slot) {
        k_pass<K, PAY, false><<<pblocks, NT, smem, s>>>(slot, in_k, in_p, alt_k, alt_p, out_k, out_p, n, plan, status, l.tiles);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        if (!PAY || slot >= 4) continue;
        k_pass<K, PAY, true><<<pblocks, NT, smem, s>>>(slot, in_k, in_p, alt_k, alt_p, out_k, out_p, n, plan, status, l.tiles);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}

}  // namespace

extern "C" {

// Bytes of scratch a sort of n lanes needs (any instantiation).
long long yak_sort_scratch_bytes(long long n) {
    return (long long)layout(n).total;
}

const char* yak_sort_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// key_bytes: 8 (int64 keys) or 4 (int32 keys).  in_p, alt_p and out_p
// null: no payload.  n >= 1 lanes in every plane; scratch holds
// yak_sort_scratch_bytes(n) bytes; *passes gets the number of passes
// the plan ran.  The input is only read.  Returns the first CUDA error
// (0 = none).
int yak_sort(int key_bytes, const void* in_k, const int* in_p, long long n,
             void* alt_k, int* alt_p, void* out_k, int* out_p,
             void* scratch, int* passes, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool pay = in_p != nullptr;
    if (n < 1 || pay != (out_p != nullptr) || pay != (alt_p != nullptr))
        return (int)cudaErrorInvalidValue;
    unsigned char* sc = static_cast<unsigned char*>(scratch);
    if (key_bytes == 8) {
        const long long* ik = static_cast<const long long*>(in_k);
        long long* ak = static_cast<long long*>(alt_k);
        long long* ok = static_cast<long long*>(out_k);
        return pay ? run<long long, true>(ik, in_p, n, ak, alt_p, ok, out_p,
                                          sc, passes, s)
                   : run<long long, false>(ik, in_p, n, ak, alt_p, ok, out_p,
                                           sc, passes, s);
    }
    if (key_bytes == 4) {
        const int* ik = static_cast<const int*>(in_k);
        int* ak = static_cast<int*>(alt_k);
        int* ok = static_cast<int*>(out_k);
        return pay ? run<int, true>(ik, in_p, n, ak, alt_p, ok, out_p, sc,
                                    passes, s)
                   : run<int, false>(ik, in_p, n, ak, alt_p, ok, out_p, sc,
                                     passes, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
