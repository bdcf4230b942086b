// Hand-written Hopper (sm_90a) kernels for the correspondence searches of
// the SLAM main path, with a plain C interface loaded through ctypes by
// lidar_slam_tpu_torch/ops/knn_cuda.py.
//
// Build (done on first use by knn_cuda.py, keyed on this file's hash):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//        -shared -Xcompiler -fPIC -o libknn.so knn.cu
//
// Both kernels evaluate the squared distance in the difference form
// ((dx*dx + dy*dy) + dz*dz) with explicitly rounded intrinsics (and
// --fmad=false), so every d2 is bit-identical to the plain PyTorch version
// (ops/knn.py:sq_dist) and indices and distances can be compared exactly.
// Both scan their targets in ascending index with a strict '<', which keeps
// the FIRST index of the minimum, as the TPU kernels' argmin does.
//
// Every C entry point returns cudaGetLastError() right after its launch; the
// Python wrapper raises when it is not 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float sq_dist(float sx, float sy, float sz,
                                         float tx, float ty, float tz) {
    const float dx = __fsub_rn(sx, tx);
    const float dy = __fsub_rn(sy, ty);
    const float dz = __fsub_rn(sz, tz);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                     __fmul_rn(dz, dz));
}

// ---------------------------------------------------------------------------
// K2: exact brute-force 1-NN.
//
// Replaces _nn1_kernel / nn1_pallas (lidar_slam_tpu/ops/knn_pallas.py:41-140).
// The TPU kernel walks a sequential (source tile, target tile) grid and keeps
// a running (min, argmin) in its output block; here one thread owns one
// source row and carries its (min, argmin) in registers over all targets.
//
// Bound on this card: FP32 ALU work, S*T distance evaluations (9 flops
// each) for every lane; the bytes are small (T*12 B per lane, read once per
// block from L2). The design feeds the ALUs from shared memory: each block
// stages a tile of NN1_TILE targets as SoA x/y/z (24 KB) that all its
// threads reuse, so the inner loop is three broadcast shared loads and the
// arithmetic. gridDim.y runs every (source, target) lane of a verify tranche
// in one launch; 128-thread blocks put S/128 * lanes blocks on the SMs.
// ---------------------------------------------------------------------------

constexpr int NN1_THREADS = 128;
constexpr int NN1_TILE = 2048;

__global__ void __launch_bounds__(NN1_THREADS)
nn1_kernel(const float* __restrict__ src,   // (B, S, 3)
           const float* __restrict__ tgt,   // (B, T, 3), masked rows at 1e6
           int S, int T,
           int* __restrict__ idx_out,       // (B, S)
           float* __restrict__ d2_out)      // (B, S)
{
    __shared__ float tx[NN1_TILE];
    __shared__ float ty[NN1_TILE];
    __shared__ float tz[NN1_TILE];

    const size_t lane = blockIdx.y;
    const float* s = src + lane * (size_t)S * 3;
    const float* t = tgt + lane * (size_t)T * 3;
    const int row = blockIdx.x * NN1_THREADS + threadIdx.x;
    const bool live = row < S;

    float sx = 0.f, sy = 0.f, sz = 0.f;
    if (live) {
        sx = s[(size_t)row * 3 + 0];
        sy = s[(size_t)row * 3 + 1];
        sz = s[(size_t)row * 3 + 2];
    }
    float best = INFINITY;
    int best_i = 0;
    for (int base = 0; base < T; base += NN1_TILE) {
        const int n = min(NN1_TILE, T - base);
        for (int k = threadIdx.x; k < n; k += NN1_THREADS) {
            const float* p = t + (size_t)(base + k) * 3;
            tx[k] = p[0];
            ty[k] = p[1];
            tz[k] = p[2];
        }
        __syncthreads();
        for (int k = 0; k < n; ++k) {
            const float d = sq_dist(sx, sy, sz, tx[k], ty[k], tz[k]);
            if (d < best) {
                best = d;
                best_i = base + k;
            }
        }
        __syncthreads();
    }
    if (live) {
        idx_out[lane * S + row] = best_i;
        d2_out[lane * S + row] = fmaxf(best, 0.f);
    }
}

// ---------------------------------------------------------------------------
// K1: slab-window fused 1-NN + correspondence gather.
//
// Replaces _match_slab_kernel / _match_slab_call
// (lidar_slam_tpu/ops/knn_pallas.py:228-310). One block per tile of `ts`
// consecutive source rows (x-sorted clouds), one thread per row. The block
// reads its own window start from starts[tile] (the TPU kernel's scalar
// prefetch), stages the window's `window` target points as SoA x/y/z in
// dynamic shared memory (12 * window bytes: 48 KB at window 4096), and every
// thread scans the whole window for its row's (min, first argmin). The
// matched point and normal are a direct load of packed row start + argmin
// (the TPU kernel needed a bf16x3 one-hot matmul for this gather), so they
// are bit-identical to tgt[idx] and normals[idx].
//
// Bound on this card: FP32 ALU work, S*window distance evaluations per ICP
// iteration (16.8M at S = window = 4096); the bytes are the window, read
// once per block. The shared-memory window is what keeps the ALUs fed. At
// S = 4096 the grid is only 16 blocks, so the kernel occupies 16 of 132 SMs:
// latency, not throughput, is what a later PR can win (split the window
// over several threads per row and merge).
// ---------------------------------------------------------------------------

__global__ void match_slab_kernel(const float* __restrict__ src,   // (Sp, 3)
                                  const float* __restrict__ tgt8,  // (Tp, 8)
                                  const int* __restrict__ starts,  // (Sp/ts,)
                                  int window,
                                  float* __restrict__ qn_out,      // (Sp, 8)
                                  float* __restrict__ d2_out,      // (Sp,)
                                  int* __restrict__ idx_out)       // (Sp,)
{
    extern __shared__ float win[];
    float* wx = win;
    float* wy = win + window;
    float* wz = win + 2 * window;

    const int start = starts[blockIdx.x];
    for (int k = threadIdx.x; k < window; k += blockDim.x) {
        const float* p = tgt8 + (size_t)(start + k) * 8;
        wx[k] = p[0];
        wy[k] = p[1];
        wz[k] = p[2];
    }
    __syncthreads();

    const size_t row = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const float sx = src[row * 3 + 0];
    const float sy = src[row * 3 + 1];
    const float sz = src[row * 3 + 2];
    float best = INFINITY;
    int best_i = 0;
    for (int k = 0; k < window; ++k) {
        const float d = sq_dist(sx, sy, sz, wx[k], wy[k], wz[k]);
        if (d < best) {
            best = d;
            best_i = k;
        }
    }
    const int g = start + best_i;
    const float4* q = reinterpret_cast<const float4*>(tgt8 + (size_t)g * 8);
    float4* o = reinterpret_cast<float4*>(qn_out + row * 8);
    o[0] = q[0];
    o[1] = q[1];
    d2_out[row] = best;
    idx_out[row] = g;
}

}  // namespace

extern "C" int lst_nn1(const void* src, const void* tgt, int lanes, int S,
                       int T, void* idx, void* d2, void* stream) {
    if (lanes <= 0 || S <= 0) return (int)cudaSuccess;
    const dim3 grid((S + NN1_THREADS - 1) / NN1_THREADS, lanes);
    nn1_kernel<<<grid, NN1_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), static_cast<const float*>(tgt), S, T,
        static_cast<int*>(idx), static_cast<float*>(d2));
    return (int)cudaGetLastError();
}

extern "C" int lst_match_slab(const void* src, const void* tgt8,
                              const void* starts, int n_tiles, int ts,
                              int window, void* qn, void* d2, void* idx,
                              void* stream) {
    if (n_tiles <= 0) return (int)cudaSuccess;
    const size_t smem = (size_t)3 * window * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            match_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    match_slab_kernel<<<n_tiles, ts, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), static_cast<const float*>(tgt8),
        static_cast<const int*>(starts), window, static_cast<float*>(qn),
        static_cast<float*>(d2), static_cast<int*>(idx));
    return (int)cudaGetLastError();
}
