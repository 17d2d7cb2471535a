// Stable stream compaction, written for Hopper (sm_90a): one pass, with a
// decoupled look-back for the tiles' output offsets.
//
// Replaces the TPU kernel yak_tpu/ops/pallas_compact.py::_kernel (with
// _compact_tile, reached through compact_raw :205).  Lanes of three
// int32 planes (khi, klo, v) are dropped where khi has bit 31 set (the
// JAX package's PAD marker 0x80000000, i.e. khi < 0 as int32); the kept
// lanes are packed to the front in input order and their number is
// returned.  Lanes past n_kept are unspecified.  The inputs may alias
// each other (both callers pass khi as klo); no output aliases an input.
//
// What bounds it on the H100: device-memory bytes.  It must read khi
// once (4 B a lane), klo and v for each kept lane, and write 12 B a kept
// lane; the arithmetic is one compare a lane and a scan.  The callers
// keep under 1 % of lanes (chkerr's run markers, the sentinel gate
// post's sentinels), so khi is nearly all of the bytes; the compact
// engine's table compaction and trio's marker pass keep dense lanes.
// What holds it back is latency: a tile cannot be written before every
// earlier tile's count is known.
//
// Design.  The TPU kernel runs its grid in order and carries the running
// kept total in SMEM from one step to the next (pallas_compact.py:8-19,
// 130-163).  Here one cudaMemsetAsync zeroes the tile counter and the
// status words, and one kernel does the rest, a block a tile.  A block
// is NT = 512 data threads and one look-back warp:
//
//   1. The block takes its tile ID from an atomic counter, so tiles
//      start in ID order and a look-back never waits on a tile that has
//      not started.
//   2. The look-back warp at once starts the decoupled look-back for the
//      kept lanes of tiles 0..t-1, over 64-bit status words (flag bits
//      beside the count), 32 words a step.  It holds no lanes of the
//      tile, so the wait for earlier tiles overlaps this tile's loads.
//   3. The data threads load khi.  Tiles are cut from the 16-byte
//      boundary at or below khi's address, so that every data thread
//      loads its Q = 8 slices with 16-byte vector loads, each warp's
//      slices adjacent; a slice that reaches before lane 0 or past lane
//      n - 1 (an unaligned head, the tail) is loaded lane by lane, and
//      those lanes count as dropped.  Nothing outside [0, n) is read.
//   4. Rank: for each load, a thread's kept count (0-4) is spread over
//      three ballots, whose popcounts give each thread the kept lanes of
//      the warp's lower threads and each warp its total; one data warp
//      scans the 128 (load, warp) totals, in lane order (a named barrier
//      joins the data warps only).  A kept lane's rank in the tile is its
//      (load, warp) prefix + its warp prefix + the kept lanes before it
//      in its own slice.  The tile's count is published at once (as its
//      inclusive value in tile 0): it waits on nothing but the tile's own
//      loads, and comes before any read of klo or v.
//   5. The data threads stage their kept lanes in shared memory at their
//      ranks: in a sparse tile (at most SPARSE = 1024 kept lanes) khi,
//      klo and v, the last two read now, while the look-back may still
//      wait; else khi and the lane's slot.  When the block joins, the
//      look-back warp publishes the inclusive count (the last tile
//      writes n_kept) and the data threads write the tile's kept lanes
//      as one contiguous run of the output from its offset: thread i
//      writes ranks i, i + NT, ... of all three planes (coalesced
//      stores), a dense tile reading klo and v at the staged slots, G
//      ranks in flight.  Only the kept lanes' sectors of klo and v are
//      read.
//
// Tile: 512 x 32 = 16384 lanes (64 KB of khi) and 96 KB of shared memory,
// two blocks an SM.  In exploratory phase probes on the H100 (clock64 in
// the kernel) the wait for earlier tiles' counts took the longest part
// of a block's life; a look-back warp that starts at once and tiles four
// times larger than 4096 lanes cut it most.  Tiles of 4096 or 8192
// lanes, look-back steps of 64-256 words, spin back-offs, L2 prefetches
// of klo and v, and a persistent block that loads its next tile while
// it writes the last were each no faster, or slower.  Every index past
// the tile is 64-bit; n must be below 2^31 (n_kept is int32).
//
// What the TPU kernel needed and this one does not: the log2(T)-stage
// butterfly that routes kept lanes left inside a vector tile (ballots
// rank them here), the 1024-aligned HBM DMA with its pending block
// re-written by the next step (stores here go to any address), the
// padded output planes longer than n, and the x64 flag flip around the
// call.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (yak_tpu_torch/ops/cuda_build.py); bound with
//        ctypes (yak_tpu_torch/ops/compact.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 512;             // data threads a tile block
constexpr int NW = NT / 32;         // data warps; one look-back warp more
constexpr int VEC = 4;              // lanes a 16-byte load
constexpr int Q = 8;                // 16-byte loads a data thread
constexpr int TILE = NT * Q * VEC;  // lanes a tile: 16384
constexpr int S = Q * NW / 32;      // (load, warp) totals a scan lane
constexpr int G = 4;                // output ranks a thread in flight
constexpr int SMEM = TILE * 6;      // staged khi values and slots: 96 KB
constexpr int SPARSE = TILE / 16;   // a tile keeping as few stages klo, v
static_assert(8 * SPARSE <= 2 * TILE, "klo and v fit the slots' room");
constexpr unsigned FULL = 0xffffffffu;
static_assert(Q * NW % 32 == 0, "one warp scans the (load, warp) totals");
static_assert(TILE <= 65536, "slots fit 16 bits");

// a status word: flag in the top two bits, count below
constexpr unsigned long long ST_AGG = 1ULL << 62;   // the tile's own count
constexpr unsigned long long ST_INC = 1ULL << 63;   // tiles 0..t's count
constexpr unsigned long long ST_VAL = ST_AGG - 1;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
    return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
    *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Decoupled look-back by one warp: the kept lanes of tiles 0..t-1 from
// their status words, 32 a step (lane l reads tile j - l), each step
// waiting until every word up to the nearest inclusive one is published.
// Tile 0 publishes an inclusive word, so the walk ends there at latest.
// (Steps of 64, 128 or 256 words waited longer on the H100.)
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
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
        acc += __shfl_sync(FULL, v, 0);
        if (inc) return acc;
        j -= 32;
    }
}

__device__ __forceinline__ void data_barrier() {
    asm volatile("bar.sync 1, %0;" ::"r"(NT) : "memory");
}

// scratch: word 0 holds the tile counter (low half) and n_kept (high
// half); the status words of the ntiles tiles follow.  All zero at entry.
// A block is NT data threads (warps 0..NW-1), which load, rank, publish
// and stage the tile, and one look-back warp (warp NW), which finds the
// tile's offset meanwhile.
__global__ void __launch_bounds__(NT + 32)
k_compact(const int* __restrict__ khi, const int* __restrict__ klo,
          const int* __restrict__ v, long long n, long long ntiles,
          unsigned long long* __restrict__ scratch, int* __restrict__ ohi,
          int* __restrict__ olo, int* __restrict__ ov) {
    extern __shared__ __align__(16) unsigned char smem[];
    int* sk = reinterpret_cast<int*>(smem);  // staged khi, in rank order
    unsigned short* sslot =                  // their slots in the tile
        reinterpret_cast<unsigned short*>(smem + 4 * TILE);
    int* slo = reinterpret_cast<int*>(smem + 4 * TILE);  // or, when sparse,
    int* sv = slo + SPARSE;                              // their klo and v
    __shared__ unsigned wsum[Q * NW];        // (load, warp) totals
    __shared__ long long s_tile, s_off;
    __shared__ unsigned s_count;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    unsigned long long* st = scratch + 1;

    if (tid == 0)
        s_tile = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
    __syncthreads();
    const long long t = s_tile;
    // slot s of the tile is lane t * TILE + s - head of khi, counted from
    // the 16-byte boundary at or below khi
    const uintptr_t addr = reinterpret_cast<uintptr_t>(khi);
    const int head = (int)((addr >> 2) & 3);
    const long long lane0 = t * TILE - head;

    if (warp == NW) {
        // the look-back warp: the kept lanes of tiles 0..t-1, while the
        // data warps load this tile
        const unsigned long long off = t > 0 ? look_back(st, t) : 0;
        if (lane == 0) s_off = (long long)off;
    } else {
        const int4* kv =
            reinterpret_cast<const int4*>(addr & ~uintptr_t(15));
        // load: slice q of thread tid is slots (q * NT + tid) * VEC + r
        int x[Q][VEC];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const int s = (q * NT + tid) * VEC;
            const long long j = lane0 + s;
            if (j >= 0 && j + VEC <= n) {
                const int4 w = kv[t * (TILE / VEC) + q * NT + tid];
                x[q][0] = w.x;
                x[q][1] = w.y;
                x[q][2] = w.z;
                x[q][3] = w.w;
            } else {
#pragma unroll
                for (int r = 0; r < VEC; ++r)
                    x[q][r] = j + r >= 0 && j + r < n ? khi[j + r] : -1;
            }
        }
        // rank within the warp by ballots, then the (load, warp) totals
        unsigned mask[Q], pre[Q];
        const unsigned lt = (1u << lane) - 1;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            unsigned m = 0;
#pragma unroll
            for (int r = 0; r < VEC; ++r) m |= (x[q][r] >= 0 ? 1u : 0u) << r;
            mask[q] = m;
            const unsigned c = __popc(m);
            const unsigned b0 = __ballot_sync(FULL, c & 1);
            const unsigned b1 = __ballot_sync(FULL, c & 2);
            const unsigned b2 = __ballot_sync(FULL, c & 4);
            pre[q] = __popc(b0 & lt) + 2 * __popc(b1 & lt)
                     + 4 * __popc(b2 & lt);
            if (lane == 0)
                wsum[q * NW + warp] = __popc(b0) + 2 * __popc(b1)
                                      + 4 * __popc(b2);
        }
        data_barrier();
        if (warp == 0) {
            // lane l scans totals l * S .. l * S + S - 1
            unsigned c[S], mine = 0;
#pragma unroll
            for (int i = 0; i < S; ++i) {
                c[i] = wsum[lane * S + i];
                mine += c[i];
            }
            unsigned inc = mine;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const unsigned y = __shfl_up_sync(FULL, inc, o);
                if (lane >= o) inc += y;
            }
            unsigned run = inc - mine;
#pragma unroll
            for (int i = 0; i < S; ++i) {
                wsum[lane * S + i] = run;
                run += c[i];
            }
            if (lane == 31) {
                // publish the tile's count: it waits on nothing
                store_status(&st[t], (t == 0 ? ST_INC : ST_AGG) | inc);
                s_count = inc;
            }
        }
        data_barrier();
        // stage the kept lanes at their ranks: in a sparse tile with their
        // klo and v, read now, while the look-back may still wait; else
        // with their slots, and klo and v are read as the run is written
        const bool sparse = s_count <= SPARSE;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            unsigned rank = wsum[q * NW + warp] + pre[q];
#pragma unroll
            for (int r = 0; r < VEC; ++r) {
                if (mask[q] >> r & 1) {
                    const int s = (q * NT + tid) * VEC + r;
                    sk[rank] = x[q][r];
                    if (sparse) {
                        slo[rank] = klo[lane0 + s];
                        sv[rank] = v[lane0 + s];
                    } else {
                        sslot[rank] = (unsigned short)s;
                    }
                    ++rank;
                }
            }
        }
    }
    __syncthreads();
    const unsigned count = s_count;
    const long long off = s_off;
    if (warp == NW) {
        if (lane == 0) {
            if (t > 0) store_status(&st[t], ST_INC | (off + count));
            if (t == ntiles - 1)
                reinterpret_cast<int*>(scratch)[1] = (int)(off + count);
        }
        return;
    }

    // the tile's run of the output, from its offset
    if (count <= SPARSE) {
        for (int i = tid; i < (int)count; i += NT) {
            ohi[off + i] = sk[i];
            olo[off + i] = slo[i];
            ov[off + i] = sv[i];
        }
        return;
    }
#pragma unroll
    for (int k0 = 0; k0 < TILE / NT; k0 += G) {
        if (k0 * NT >= (int)count) break;
        int h[G], a[G], b[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const int i = (k0 + g) * NT + tid;
            if (i < (int)count) {
                const long long j = lane0 + sslot[i];
                h[g] = sk[i];
                a[g] = klo[j];
                b[g] = v[j];
            }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
            const int i = (k0 + g) * NT + tid;
            if (i < (int)count) {
                ohi[off + i] = h[g];
                olo[off + i] = a[g];
                ov[off + i] = b[g];
            }
        }
    }
}

// tiles of a call on khi with n lanes: cut from the 16-byte boundary at
// or below khi, which lies head = (address / 4) mod 4 lanes before khi's
// first; a call runs at least one tile (it writes n_kept)
long long tile_count(const void* khi, long long n) {
    const long long head =
        (long long)((reinterpret_cast<uintptr_t>(khi) >> 2) & 3);
    const long long t = (n + head + TILE - 1) / TILE;
    return t > 0 ? t : 1;
}

}  // namespace

extern "C" {

int yak_compact_tile(void) { return TILE; }

const char* yak_compact_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 8-byte words of scratch a call on khi (its address) with n lanes takes:
// word 0 holds the tile counter (low half) and n_kept (int32, high half);
// the status words of the tiles follow.
long long yak_compact_scratch_words(const void* khi, long long n) {
    return 1 + tile_count(khi, n);
}

// n < 2^31 lanes; scratch: yak_compact_scratch_words(khi, n) words of
// device memory, zeroed here.  Outputs: ohi, olo, ov [n].  Launches on
// `stream` of CUDA device `device`, and leaves the calling thread's
// current device as it was.  Returns the first CUDA error (0 = none).
int yak_compact(const int* khi, const int* klo, const int* v, long long n,
                unsigned long long* scratch, int* ohi, int* olo, int* ov,
                void* stream, int device) {
    if (n < 0 || n >= (1LL << 31) || device < 0 || device >= 64)
        return (int)cudaErrorInvalidValue;
    const long long ntiles = tile_count(khi, n);
    int cur = 0;
    cudaError_t e = cudaGetDevice(&cur);
    if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    // dynamic shared memory above 48 KB is allowed per device, once
    static bool smem_set[64];
    if (!smem_set[device]) {
        e = cudaFuncSetAttribute(k_compact,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM);
        smem_set[device] = e == cudaSuccess;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (e == cudaSuccess)
        e = cudaMemsetAsync(
            scratch, 0, (size_t)(1 + ntiles) * sizeof(unsigned long long), s);
    if (e == cudaSuccess) {
        k_compact<<<(unsigned)ntiles, NT + 32, SMEM, s>>>(
            khi, klo, v, n, ntiles, scratch, ohi, olo, ov);
        e = cudaGetLastError();
    }
    if (cur != device) {
        const cudaError_t e2 = cudaSetDevice(cur);
        if (e == cudaSuccess) e = e2;
    }
    return (int)e;
}

}  // extern "C"
