// Stable stream compaction, written for Hopper (sm_90a).
//
// Replaces the TPU kernel yak_tpu/ops/pallas_compact.py::_kernel (with
// _compact_tile, reached through compact_raw :205).  Lanes of three
// int32 planes (khi, klo, v) are dropped where khi has bit 31 set (the
// JAX package's PAD marker 0x80000000, i.e. khi < 0 as int32); the kept
// lanes are packed to the front in input order and their number is
// returned.  Lanes past n_kept are unspecified.
//
// What bounds it on the H100: device-memory bytes.  It reads khi twice
// (4 B a lane each time) and klo/v once for each kept lane, and writes
// 12 B a kept lane; the arithmetic per lane is one compare and a scan
// step.  At chkerr's run markers (a few kept lanes per thousand) that is
// about 8 B a lane.
//
// Design.  The TPU kernel runs its grid in order and carries the running
// kept total in SMEM from one step to the next (pallas_compact.py:8-19,
// 130-163).  On Hopper the blocks run in parallel and in no order, so the
// carry becomes a scan over per-tile counts, in three launches:
//
//   1. k_count: per tile of TILE lanes, the kept count;
//   2. k_scan_offsets: one block scans the tile counts into each tile's
//      output offset and writes n_kept;
//   3. k_scatter: per tile, khi is staged in shared memory, each thread
//      ranks its IPT consecutive lanes, a block scan turns the ranks
//      into output positions, and the kept lanes are written, in order,
//      by a coalesced pass over the tile.
//
// What the TPU kernel needed and this one does not: the log2(T)-stage
// butterfly that routes kept lanes left inside a vector tile (a
// per-lane exclusive rank does it here), the 1024-aligned HBM DMA with
// its pending block re-written by the next step (stores here go to any
// address), the padded output planes longer than n, and the x64 flag
// flip around the call.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (yak_tpu_torch/ops/cuda_build.py); bound with
//        ctypes (yak_tpu_torch/ops/compact.py).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;             // threads per tile block
constexpr int IPT = 8;              // consecutive lanes per thread
constexpr int TILE = NT * IPT;      // lanes per tile
constexpr int SCAN_NT = 1024;       // threads of the one scan block
constexpr unsigned FULL = 0xffffffffu;

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

__global__ void __launch_bounds__(NT)
k_count(const int* __restrict__ khi, long long n, int* __restrict__ tile_cnt) {
    __shared__ long long warp_tot[NT / 32];
    __shared__ long long total;
    const long long base = (long long)blockIdx.x * TILE;
    int c = 0;
    for (int i = threadIdx.x; i < TILE; i += NT) {
        const long long j = base + i;
        if (j < n && khi[j] >= 0) ++c;
    }
    block_sum_excl<NT>(c, warp_tot, &total);
    if (threadIdx.x == 0) tile_cnt[blockIdx.x] = (int)total;
}

__global__ void __launch_bounds__(SCAN_NT)
k_scan_offsets(const int* __restrict__ tile_cnt, long long ntiles,
               long long* __restrict__ tile_off, int* __restrict__ n_kept) {
    __shared__ long long warp_tot[SCAN_NT / 32];
    __shared__ long long total;
    const long long per = (ntiles + SCAN_NT - 1) / SCAN_NT;
    const long long t0 = min(threadIdx.x * per, ntiles);
    const long long t1 = min(t0 + per, ntiles);
    long long mine = 0;
    for (long long t = t0; t < t1; ++t) mine += tile_cnt[t];
    long long off = block_sum_excl<SCAN_NT>(mine, warp_tot, &total);
    for (long long t = t0; t < t1; ++t) {
        tile_off[t] = off;
        off += tile_cnt[t];
    }
    if (threadIdx.x == 0) *n_kept = (int)total;
}

__global__ void __launch_bounds__(NT)
k_scatter(const int* __restrict__ khi, const int* __restrict__ klo,
          const int* __restrict__ v, long long n,
          const long long* __restrict__ tile_off, int* __restrict__ ohi,
          int* __restrict__ olo, int* __restrict__ ov) {
    __shared__ int sk[TILE];
    __shared__ int srank[TILE];
    __shared__ long long warp_tot[NT / 32];
    __shared__ long long total;
    const long long base = (long long)blockIdx.x * TILE;
    // stage the tile's khi (dropped past n) with coalesced loads
    for (int i = threadIdx.x; i < TILE; i += NT) {
        const long long j = base + i;
        sk[i] = j < n ? khi[j] : -1;
    }
    __syncthreads();
    // rank: each thread's IPT consecutive lanes, then a block scan
    const int p0 = threadIdx.x * IPT;
    int mine = 0;
#pragma unroll
    for (int q = 0; q < IPT; ++q) mine += sk[p0 + q] >= 0 ? 1 : 0;
    int r = (int)block_sum_excl<NT>(mine, warp_tot, &total);
#pragma unroll
    for (int q = 0; q < IPT; ++q) {
        srank[p0 + q] = r;
        r += sk[p0 + q] >= 0 ? 1 : 0;
    }
    __syncthreads();
    const long long off = tile_off[blockIdx.x];
    for (int i = threadIdx.x; i < TILE; i += NT) {
        const int h = sk[i];
        if (h < 0) continue;
        const long long j = base + i;
        const long long pos = off + srank[i];
        ohi[pos] = h;
        olo[pos] = klo[j];
        ov[pos] = v[j];
    }
}

}  // namespace

extern "C" {

int yak_compact_tile(void) { return TILE; }

const char* yak_compact_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Scratch (device memory, from the caller): tile_cnt[ntiles],
// tile_off[ntiles], with ntiles = ceil(n / TILE) >= 1.  Outputs: ohi,
// olo, ov [n] and n_kept[1].  Returns the first CUDA error (0 = none).
int yak_compact(const int* khi, const int* klo, const int* v, long long n,
                long long ntiles, int* tile_cnt, long long* tile_off,
                int* ohi, int* olo, int* ov, int* n_kept, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    k_count<<<(unsigned)ntiles, NT, 0, s>>>(khi, n, tile_cnt);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    k_scan_offsets<<<1, SCAN_NT, 0, s>>>(tile_cnt, ntiles, tile_off, n_kept);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    k_scatter<<<(unsigned)ntiles, NT, 0, s>>>(khi, klo, v, n, tile_off, ohi,
                                              olo, ov);
    return (int)cudaGetLastError();
}

}  // extern "C"
