// Ascending batch sort of the psort engine, written for Hopper (sm_90a).
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
// Layout.  The lane count is padded to n2, the next power of two, with
// (key max, payload max) lanes, which sort after or equal to every real
// lane (an INT64_MAX invalid lane with payload INT32_MAX is equal to a
// pad, so cutting the output back to n is exact).  The caller passes
// the n input lanes and two n2-lane output planes; the first kernel
// reads the input, pads in flight and writes the output planes, and
// every later pass works in place on them, so the input is never
// written.
//
// The network is the bitonic one of pallas_sort.py:27-31: level `size`
// (2, 4, ..., n2), stage `stride` (size/2, ..., 1); lane a is paired
// with a + stride when bit log2(stride) of a is clear, and the pair is
// put in ascending order when bit log2(size) of a's global index is
// clear, else in descending order.  Three kernels run it:
//
//   (a) k_local:    one block sorts a shared-memory tile of TILE lanes
//                   through levels 2..TILE (replaces kernels 3 and 6);
//   (b) k_exchange: one compare-exchange stage at a stride >= TILE,
//                   one thread a pair, in device memory (replaces 4, 7);
//   (c) k_tail:     stages TILE/2..1 of a level above TILE on a
//                   shared-memory tile (replaces 3 and 5).
//
// For n2 = 2^25 and TILE = 2^13 that is 1 local pass, 78 exchange passes
// and 12 tails.  Index math is 64-bit throughout.
//
// What bounds it on the H100: device-memory bytes.  Each of the
// O(log^2 n2) passes reads and writes every lane (12 B a lane with an
// int64 key and a payload), so at 2^25 int64 lanes the 91 passes move
// about 48 GB, some 15 ms at 3.35 TB/s, against a lower bound of one
// read of the input and one write of the output.  The shared-memory
// tiles keep the 91 stages of the local pass and the 13 of each tail on
// chip; what is left is the device-memory exchange passes, which a
// later design (a radix sort, or several stages a pass in registers)
// removes.  A tile of 2^13 lanes takes at most 96 KB of shared memory
// (int64 key + payload), so two blocks fit on an SM.
//
// What the TPU kernels needed and these do not: the hi/lo u32 split of
// 64-bit keys (int64 compares here), neg_keys (the port's merge takes
// ascending keys), the x64 flag flips, the VMEM option and the roll
// tricks that move a partner lane within an (8, 128) tile (shared memory
// is addressed by lane here).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (yak_tpu_torch/ops/cuda_build.py); bound with
//        ctypes (yak_tpu_torch/ops/sort.py).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int LOG_TILE = 13;
constexpr int TILE = 1 << LOG_TILE;   // lanes a block sorts in shared memory
constexpr int NT = 512;               // threads of the tile kernels
constexpr int XNT = 256;              // threads of the exchange kernel

template <typename K> __device__ __forceinline__ K key_max();
template <> __device__ __forceinline__ long long key_max<long long>() {
    return LLONG_MAX;
}
template <> __device__ __forceinline__ int key_max<int>() { return INT_MAX; }

template <typename K, bool PAY>
__device__ __forceinline__ bool lane_less(K ka, int pa, K kb, int pb) {
    return ka < kb || (PAY && ka == kb && pa < pb);
}

// Put lanes a < b of (k, p) in ascending order when asc, else descending;
// equal lanes stay.  k and p are shared or device memory.
template <typename K, bool PAY>
__device__ __forceinline__ void cmpx(K* k, int* p, long long a, long long b,
                                     bool asc) {
    const K ka = k[a], kb = k[b];
    const int pa = PAY ? p[a] : 0, pb = PAY ? p[b] : 0;
    const bool swap = asc ? lane_less<K, PAY>(kb, pb, ka, pa)
                          : lane_less<K, PAY>(ka, pa, kb, pb);
    if (swap) {
        k[a] = kb;
        k[b] = ka;
        if (PAY) {
            p[a] = pb;
            p[b] = pa;
        }
    }
}

// Stages s0, s0/2, ..., 1 of level `size` on a shared-memory tile whose
// first lane has global index `base`.
template <typename K, bool PAY>
__device__ void tile_stages(K* sk, int* sp, int tile, long long base,
                            long long size, int s0) {
    for (int stride = s0; stride > 0; stride >>= 1) {
        for (int q = threadIdx.x; q < tile / 2; q += NT) {
            const int a = ((q & ~(stride - 1)) << 1) | (q & (stride - 1));
            cmpx<K, PAY>(sk, sp, a, a + stride, ((base + a) & size) == 0);
        }
        __syncthreads();
    }
}

// The shared-memory planes of a tile of `tile` lanes: keys, then payloads.
template <typename K>
__device__ __forceinline__ K* smem_keys() {
    extern __shared__ __align__(16) unsigned char smem[];
    return reinterpret_cast<K*>(smem);
}

// (a) Levels 2..tile of each tile, reading the n input lanes (pads past
// n) and writing the n2-lane output planes.
template <typename K, bool PAY>
__global__ void __launch_bounds__(NT)
k_local(const K* __restrict__ in_k, const int* __restrict__ in_p,
        long long n, int tile, K* __restrict__ out_k,
        int* __restrict__ out_p) {
    K* sk = smem_keys<K>();
    int* sp = reinterpret_cast<int*>(sk + tile);
    const long long base = (long long)blockIdx.x * tile;
    for (int i = threadIdx.x; i < tile; i += NT) {
        const long long j = base + i;
        const bool real = j < n;
        sk[i] = real ? in_k[j] : key_max<K>();
        if (PAY) sp[i] = real ? in_p[j] : INT_MAX;
    }
    __syncthreads();
    for (long long size = 2; size <= tile; size <<= 1)
        tile_stages<K, PAY>(sk, sp, tile, base, size, (int)(size >> 1));
    for (int i = threadIdx.x; i < tile; i += NT) {
        out_k[base + i] = sk[i];
        if (PAY) out_p[base + i] = sp[i];
    }
}

// (b) One stage of level `size` at stride 2^log_stride >= TILE, in place;
// `half` = n2 / 2 pairs.
template <typename K, bool PAY>
__global__ void __launch_bounds__(XNT)
k_exchange(K* __restrict__ k, int* __restrict__ p, long long half,
           long long size, int log_stride) {
    const long long q = (long long)blockIdx.x * XNT + threadIdx.x;
    if (q >= half) return;
    const long long stride = 1LL << log_stride;
    const long long a = ((q >> log_stride) << (log_stride + 1))
                        | (q & (stride - 1));
    cmpx<K, PAY>(k, p, a, a + stride, (a & size) == 0);
}

// (c) Stages TILE/2..1 of level `size` > TILE on each tile, in place.
template <typename K, bool PAY>
__global__ void __launch_bounds__(NT)
k_tail(K* __restrict__ k, int* __restrict__ p, long long size) {
    K* sk = smem_keys<K>();
    int* sp = reinterpret_cast<int*>(sk + TILE);
    const long long base = (long long)blockIdx.x * TILE;
    for (int i = threadIdx.x; i < TILE; i += NT) {
        sk[i] = k[base + i];
        if (PAY) sp[i] = p[base + i];
    }
    __syncthreads();
    tile_stages<K, PAY>(sk, sp, TILE, base, size, TILE / 2);
    for (int i = threadIdx.x; i < TILE; i += NT) {
        k[base + i] = sk[i];
        if (PAY) p[base + i] = sp[i];
    }
}

template <typename K, bool PAY>
int run(const K* in_k, const int* in_p, long long n, long long n2, K* k,
        int* p, cudaStream_t s) {
    const size_t lane_bytes = sizeof(K) + (PAY ? sizeof(int) : 0);
    const int smem_max = (int)(TILE * lane_bytes);
    cudaError_t e = cudaFuncSetAttribute(
        k_local<K, PAY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_max);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(k_tail<K, PAY>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_max);
    if (e != cudaSuccess) return (int)e;

    const int tile = (int)(n2 < TILE ? n2 : TILE);
    k_local<K, PAY><<<(unsigned)(n2 / tile), NT, tile * lane_bytes, s>>>(
        in_k, in_p, n, tile, k, p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    const long long half = n2 / 2;
    const unsigned xblocks = (unsigned)((half + XNT - 1) / XNT);
    int log_size = LOG_TILE + 1;
    for (long long size = 2LL * TILE; size <= n2; size <<= 1, ++log_size) {
        for (int ls = log_size - 1; ls >= LOG_TILE; --ls) {
            k_exchange<K, PAY><<<xblocks, XNT, 0, s>>>(k, p, half, size, ls);
            e = cudaGetLastError();
            if (e != cudaSuccess) return (int)e;
        }
        k_tail<K, PAY><<<(unsigned)(n2 / TILE), NT, smem_max, s>>>(k, p,
                                                                   size);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    return 0;
}

}  // namespace

extern "C" {

int yak_sort_tile(void) { return TILE; }

const char* yak_sort_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// key_bytes: 8 (int64 keys) or 4 (int32 keys).  in_p and out_p null: no
// payload.  n >= 1 input lanes; n2 = the next power of two >= n; out_k
// and out_p hold n2 lanes.  Returns the first CUDA error (0 = none).
int yak_sort(int key_bytes, const void* in_k, const int* in_p, long long n,
             long long n2, void* out_k, int* out_p, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool pay = in_p != nullptr;
    if (n < 1 || n2 < n || (n2 & (n2 - 1)) != 0 || pay != (out_p != nullptr))
        return (int)cudaErrorInvalidValue;
    if (key_bytes == 8) {
        const long long* ik = static_cast<const long long*>(in_k);
        long long* ok = static_cast<long long*>(out_k);
        return pay ? run<long long, true>(ik, in_p, n, n2, ok, out_p, s)
                   : run<long long, false>(ik, in_p, n, n2, ok, out_p, s);
    }
    if (key_bytes == 4) {
        const int* ik = static_cast<const int*>(in_k);
        int* ok = static_cast<int*>(out_k);
        return pay ? run<int, true>(ik, in_p, n, n2, ok, out_p, s)
                   : run<int, false>(ik, in_p, n, n2, ok, out_p, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
