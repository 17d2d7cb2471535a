// The last set lane of a mask, written for Hopper (sm_90a): one pass,
// with a decoupled look-back for the tiles' prefixes.
//
// For each lane i, out[i] is the last lane j <= i whose mask byte is not
// 0, else -1: the running maximum of the set lanes' indices, which the
// JAX package computes as jax.lax.cummax of where(mask, lane, -1) (the
// key runs of the Bloom gate posts, yak_tpu/ops/countstep.py and
// yak_tpu/ops/bloom.py; the sort-merge engine's run sums; trio's type
// runs).  It replaces no TPU kernel: XLA scanned those on the TPU, and
// PyTorch's torch.cummax scans a 1-D tensor in one block on the card
// (22.3 ms at 8.4 M lanes on the H100), which is why this kernel exists.
//
// What bounds it on the H100: device-memory bytes, 1 B read and 4 B
// written a lane (0.13 ms at 84 M lanes at 3.35 TB/s); the arithmetic
// is a compare a lane and a few shuffles a warp.  No temporary beyond
// the output and one status word a tile.
//
// Design.  One cudaMemsetAsync zeroes the tile counter and the status
// words, and one kernel does the rest, a block a tile of TILE = 8192
// lanes.  A block is NT = 256 data threads and one look-back warp:
//
//   1. The block takes its tile ID from an atomic counter, so tiles
//      start in ID order and a look-back never waits on a tile that has
//      not started.
//   2. The look-back warp at once looks for the last set lane of tiles
//      0..t-1 (below), while the data threads load the tile.
//   3. Slice q of data thread tid is the 4 lanes from slot
//      (q * NT + tid) * 4: one 4-byte load a slice (byte loads where the
//      mask is not 4-byte aligned or the slice reaches past n), each
//      warp's slices adjacent, and later one 16-byte store of its 4
//      outputs, each warp's stores one 512-byte run.
//   4. A slice's last set lane (its highest set byte) is its aggregate.
//      Within a warp the nearest lower thread with a set lane gives a
//      slice its prefix (a ballot and a shuffle: the set lanes' indices
//      grow with the slot); one warp max-scans the Q x NW (slice, warp)
//      totals in slot order, and the tile's aggregate is published at
//      once (as its inclusive value in tile 0).
//   5. When the block joins, the look-back warp publishes the inclusive
//      value max(prefix, aggregate), and each data thread writes its
//      slices: the running last set lane from the slice's prefix.
//
// The look-back combines with max, and the indices grow with the tile,
// so tile t's prefix is the value of the nearest earlier tile whose
// word is inclusive or holds a set lane: the walk stops there, and at
// tile t - 1 wherever the mask is not almost empty.  Status words hold
// a flag in the top two bits and the last set lane + 1 below (0: none).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (yak_tpu_torch/ops/cuda_build.py); bound with
//        ctypes (yak_tpu_torch/ops/scan.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;             // data threads a tile block
constexpr int NW = NT / 32;         // data warps; one look-back warp more
constexpr int VEC = 4;              // lanes a slice: one 4-byte load
constexpr int Q = 8;                // slices a data thread
constexpr int TILE = NT * Q * VEC;  // lanes a tile: 8192
static_assert(Q * NW <= 64, "one warp scans the (slice, warp) totals, 2 a "
                            "lane");
constexpr unsigned FULL = 0xffffffffu;

// a status word: flag in the top two bits, last set lane + 1 below
constexpr unsigned long long ST_AGG = 1ULL << 62;   // the tile's own lanes
constexpr unsigned long long ST_INC = 1ULL << 63;   // tiles 0..t's lanes
constexpr unsigned long long ST_VAL = ST_AGG - 1;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
    return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
    *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Decoupled look-back by one warp: the last set lane + 1 of tiles
// 0..t-1 (0: none), 32 words a step (lane l reads tile j - l).  The
// nearest word that is inclusive, or that holds a set lane, decides;
// a step waits until every word up to it is published.  Tile 0
// publishes an inclusive word, and words before it read as one.
__device__ unsigned long long look_back(const unsigned long long* st,
                                        long long t) {
    const int lane = threadIdx.x & 31;
    for (long long j = t - 1;;) {
        const unsigned long long w =
            j - lane >= 0 ? load_status(&st[j - lane]) : ST_INC;
        const unsigned dec = __ballot_sync(
            FULL, (w & ST_INC) != 0 || (w & ST_VAL) != 0);
        const unsigned pub = __ballot_sync(FULL, w != 0);
        const int first = dec ? __ffs(dec) - 1 : 31;
        const unsigned need = first == 31 ? FULL : (2u << first) - 1;
        if ((pub & need) != need) continue;
        if (dec) return __shfl_sync(FULL, w & ST_VAL, first);
        j -= 32;
    }
}

__device__ __forceinline__ void data_barrier() {
    asm volatile("bar.sync 1, %0;" ::"r"(NT) : "memory");
}

// scratch: word 0 holds the tile counter; the status words of the
// ntiles tiles follow.  All zero at entry.  `aligned`: the mask lies on
// a 4-byte boundary.  out must lie on a 16-byte boundary.
__global__ void __launch_bounds__(NT + 32)
k_last_set_lane(const unsigned char* __restrict__ mask, long long n,
                int aligned, unsigned long long* __restrict__ scratch,
                int* __restrict__ out) {
    __shared__ int wsum[Q * NW];             // (slice, warp) totals
    __shared__ long long s_tile;
    __shared__ int s_agg, s_prefix;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    unsigned long long* st = scratch + 1;

    if (tid == 0)
        s_tile = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
    __syncthreads();
    const long long t = s_tile;
    const long long lane0 = t * TILE;

    unsigned bits[Q];   // the set lanes of each slice, bit r = lane r
    int pre[Q];         // each slice's prefix within its (slice, warp)
    if (warp == NW) {
        // the look-back warp: the last set lane of tiles 0..t-1, while
        // the data warps load this tile
        const unsigned long long p = t > 0 ? look_back(st, t) : 0;
        if (lane == 0) s_prefix = (int)p - 1;
    } else {
        const unsigned lt = (1u << lane) - 1;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const long long j = lane0 + (q * NT + tid) * VEC;
            unsigned b = 0;
            if (aligned && j + VEC <= n) {
                const unsigned w = *reinterpret_cast<const unsigned*>(
                    mask + j);
#pragma unroll
                for (int r = 0; r < VEC; ++r)
                    b |= ((w >> (8 * r)) & 0xffu ? 1u : 0u) << r;
            } else {
#pragma unroll
                for (int r = 0; r < VEC; ++r)
                    if (j + r < n && mask[j + r]) b |= 1u << r;
            }
            bits[q] = b;
        }
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            // the slice's last set lane; the nearest lower thread's
            // gives its prefix, the highest thread's the warp's total
            const int agg =
                bits[q] ? (int)(lane0 + (q * NT + tid) * VEC) + 31
                              - __clz(bits[q])
                        : -1;
            const unsigned has = __ballot_sync(FULL, bits[q] != 0);
            const unsigned lower = has & lt;
            const int below =
                __shfl_sync(FULL, agg, lower ? 31 - __clz(lower) : 0);
            pre[q] = lower ? below : -1;
            const int top = __shfl_sync(FULL, agg, has ? 31 - __clz(has) : 0);
            if (lane == 0) wsum[q * NW + warp] = has ? top : -1;
        }
        data_barrier();
        if (warp == 0) {
            // lane l max-scans totals 2l, 2l + 1 (slot order); entries
            // past Q * NW read as -1
            const int e0 = 2 * lane < Q * NW ? wsum[2 * lane] : -1;
            const int e1 = 2 * lane + 1 < Q * NW ? wsum[2 * lane + 1] : -1;
            const int mine = max(e0, e1);
            int inc = mine;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(FULL, inc, o);
                if (lane >= o) inc = max(inc, y);
            }
            int ex = __shfl_up_sync(FULL, inc, 1);
            if (lane == 0) ex = -1;
            if (2 * lane < Q * NW) wsum[2 * lane] = ex;
            if (2 * lane + 1 < Q * NW) wsum[2 * lane + 1] = max(ex, e0);
            if (lane == 31) {
                // publish the tile's aggregate: it waits on nothing
                store_status(&st[t], (t == 0 ? ST_INC : ST_AGG)
                                         | (unsigned long long)(inc + 1));
                s_agg = inc;
            }
        }
    }
    __syncthreads();
    const int prefix = s_prefix;
    if (warp == NW) {
        if (lane == 0 && t > 0) {
            const int inc = max(prefix, s_agg);
            store_status(&st[t], ST_INC | (unsigned long long)(inc + 1));
        }
        return;
    }

    // the tile's outputs: each slice's running last set lane
    const bool vec_store = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const long long j = lane0 + (q * NT + tid) * VEC;
        if (j >= n) break;
        int cur = max(max(prefix, wsum[q * NW + warp]), pre[q]);
        int o[VEC];
#pragma unroll
        for (int r = 0; r < VEC; ++r) {
            if (bits[q] >> r & 1) cur = (int)(j + r);
            o[r] = cur;
        }
        if (vec_store && j + VEC <= n) {
            *reinterpret_cast<int4*>(out + j) = make_int4(o[0], o[1], o[2],
                                                          o[3]);
        } else {
#pragma unroll
            for (int r = 0; r < VEC; ++r)
                if (j + r < n) out[j + r] = o[r];
        }
    }
}

long long tile_count(long long n) {
    const long long t = (n + TILE - 1) / TILE;
    return t > 0 ? t : 1;
}

}  // namespace

extern "C" {

int yak_last_set_lane_tile(void) { return TILE; }

const char* yak_last_set_lane_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 8-byte words of scratch a call on n lanes takes: word 0 holds the tile
// counter; the status words of the tiles follow.
long long yak_last_set_lane_scratch_words(long long n) {
    return 1 + tile_count(n);
}

// 1 <= n < 2^31 lanes of mask (one byte a lane, set where not 0); out:
// int32 [n] on a 16-byte boundary; scratch:
// yak_last_set_lane_scratch_words(n) words of device memory, zeroed
// here.  Launches on `stream` of CUDA device `device`, and leaves the
// calling thread's current device as it was.  Returns the first CUDA
// error (0 = none).
int yak_last_set_lane(const unsigned char* mask, long long n,
                      unsigned long long* scratch, int* out, void* stream,
                      int device) {
    if (n < 1 || n >= (1LL << 31) || device < 0 || device >= 64)
        return (int)cudaErrorInvalidValue;
    const long long ntiles = tile_count(n);
    int cur = 0;
    cudaError_t e = cudaGetDevice(&cur);
    if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    e = cudaMemsetAsync(
        scratch, 0, (size_t)(1 + ntiles) * sizeof(unsigned long long), s);
    if (e == cudaSuccess) {
        const int aligned = (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
        k_last_set_lane<<<(unsigned)ntiles, NT + 32, 0, s>>>(
            mask, n, aligned, scratch, out);
        e = cudaGetLastError();
    }
    if (cur != device) {
        const cudaError_t e2 = cudaSetDevice(cur);
        if (e == cudaSuccess) e = e2;
    }
    return (int)e;
}

}  // extern "C"
