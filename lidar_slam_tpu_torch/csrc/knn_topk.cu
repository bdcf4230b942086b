// The exact k-NN search of the k-NN PCA normals as one hand-written Hopper
// (sm_90a) kernel, with a plain C interface loaded through ctypes by
// lidar_slam_tpu_torch/ops/knn_topk_cuda.py.
//
// Build (done on first use by knn_topk_cuda.py through knn_cuda.build, keyed
// on this file's hash, with knn_cuda.NVCC_FLAGS):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//        -shared -Xcompiler -fPIC -Xptxas=-v -o libknn_topk.so knn_topk.cu
//
// It replaces no Pallas kernel: the JAX package's k-NN is left to XLA, a
// full-f32 matmul and lax.top_k over target chunks
// (lidar_slam_tpu/ops/knn.py:knn). The port ran the same chunked matrix form
// in ATen (ops/knn.py:knn): per 2,048-column chunk a matmul, a (rows x 2,068)
// int64 key tensor made in device memory and a radix top-k over it.
//
// The contract. For every row of every lane of (B, N, 3) points (masked rows
// already moved to the 1e6 sentinel by the wrapper), the k nearest rows of
// the same lane, the row itself included, ranked by the key
//     (bits(d2) << 32) | index,   d2 = (dx*dx + dy*dy) + dz*dz
// in round-to-nearest f32 with no FMA (explicit intrinsics and --fmad=false):
// the smaller d2 first and, among equal d2, the lower index. Output idx
// (B, N, k) int32 and d2 (B, N, k) f32, nearest first. The plain PyTorch
// version (knn_topk_cuda.knn_topk_torch: ops/knn.py:sq_dist, the same keys,
// torch.topk) gives the same indices and distances bit for bit. Rows that
// hold fewer than k candidates end in (index 0, +inf), the plain version's
// starting keys. k is 1 to 32; the kernel keeps the K nearest, K = k rounded
// up to a multiple of 4 up to 20 and 32 above (a template per K: ptxas
// spilled a few bytes at K = 24), and writes the first k.
//
// The bound on this card. Every row against every row of its lane: N^2
// distances of 8 FP32 instructions, none fusable under the contract, at
// SMs x 128 lanes x clock (33.5 T/s on an H100 SXM): 0.26 ms for one
// 32,768-row frame. The bytes are a few MB (the points, the outputs, the
// split lists), microseconds of HBM time. So the FP32 pipes and the issue
// slots that feed them are the busy unit, and two costs sit on top of the
// distances: the compare that tests a candidate, and the insertions, whose
// compare-and-swap chain runs for the whole warp when one lane inserts.
//
// What the design does about it:
//  - a thread owns one query row and keeps its K best (d2, index) sorted
//    ascending in registers: arrays indexed only at compile time (unrolled
//    insertions), so nothing moves to local memory (ptxas: 0 bytes spill);
//  - the targets stream through a shared-memory tile as float4 (one
//    broadcast load a target for the whole warp); eight distances are taken
//    at a time and tested once against the threshold with their minimum,
//    and only a group that passes is taken again target by target (one
//    copy of the insertion in the code: the loops that insert are not
//    unrolled, which keeps the registers within bounds);
//  - the threshold: with rows voxel-ordered (x-major), a scan in index
//    order approaches a row's neighbours gradually and inserts ~1,800 times
//    a row, and one warp inserts at ~15% of all targets. So each block
//    first runs a pass over the PRE rows around its own (a sorted list of
//    distances only, two min/max instructions a position): the K-th of
//    those is at least the K-th over the whole lane, and a candidate beyond
//    it can never be among the K. The scan then inserts only below
//    min(that bound, its own K-th): ~10x fewer insertion events a warp;
//  - filling the card: a lane's targets are cut into splits, one block per
//    (lane, 256 query rows, split), the number of splits chosen by the
//    wrapper from N, the lanes, the SM count and this kernel's occupancy;
//    each split's scan runs in index order, so among equal d2 a strict '<'
//    keeps the lower index;
//  - the merge: each block writes its split's K (d2, index) pairs in device
//    memory, takes a ticket of its (lane, row block), and the block drawing
//    the last ticket merges the other splits' lists into its own under the
//    full key order, writes idx and d2 and resets the ticket: one launch,
//    any order of arrival. Keys are unique, so the merge order cannot
//    change the answer.
//
// Every C entry point returns the launch's error code; the Python wrapper
// raises when it is not 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;  // query rows a block, one a thread
constexpr int TILE = 1024;    // targets a shared-memory tile
constexpr int GROUP = 8;      // distances tested together
constexpr int MAX_K = 32;

__device__ __forceinline__ float sq_dist(float sx, float sy, float sz,
                                         float tx, float ty, float tz) {
    const float dx = __fsub_rn(sx, tx);
    const float dy = __fsub_rn(sy, ty);
    const float dz = __fsub_rn(sz, tz);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                     __fmul_rn(dz, dz));
}

// c < d[K-1]: c enters the ascending list d, the last entry drops out
template <int K>
__device__ __forceinline__ void push_distance(float (&d)[K], float c) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
        const float lo = fminf(d[j], c);
        c = fmaxf(d[j], c);
        d[j] = lo;
    }
}

// (c, ci) enters the list ahead of the entries it is less than, and every
// entry from there on moves down one place: with full_key, less by (d2,
// index); else by d2 alone, which is the key order when ci is above every
// index in the list (a split scanned in order)
template <int K, bool full_key>
__device__ __forceinline__ void insert(float (&d)[K], int (&ix)[K], float c,
                                       int ci) {
    bool sw = false;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        sw = sw || (full_key ? (c < d[j] || (c == d[j] && ci < ix[j]))
                             : c < d[j]);
        const float td = d[j];
        const int ti = ix[j];
        d[j] = sw ? c : td;
        ix[j] = sw ? ci : ti;
        c = sw ? td : c;
        ci = sw ? ti : ci;
    }
}

template <int K>
__global__ void __launch_bounds__(THREADS)
knn_topk_kernel(const float* __restrict__ pts,  // (B, N, 3), masked at 1e6
                int N, int k, int tiles_per_split, int pre,
                float* __restrict__ part_d,     // (B, splits, K, N) scratch
                int* __restrict__ part_i,       // (B, splits, K, N) scratch
                unsigned* __restrict__ tickets, // (B, row blocks): 0 in, 0 out
                int* __restrict__ idx_out,      // (B, N, k)
                float* __restrict__ d2_out)     // (B, N, k)
{
    __shared__ __align__(16) float4 tile[TILE];
    __shared__ bool s_last;

    const int tid = threadIdx.x;
    const size_t lane = blockIdx.z;
    const int split = blockIdx.y, n_split = gridDim.y;
    const float* p = pts + lane * (size_t)N * 3;
    const int row0 = blockIdx.x * THREADS;
    const int row = row0 + tid;
    const bool live = row < N;
    const float qx = live ? p[(size_t)row * 3 + 0] : 0.f;
    const float qy = live ? p[(size_t)row * 3 + 1] : 0.f;
    const float qz = live ? p[(size_t)row * 3 + 2] : 0.f;

    // targets [t0, t0 + n), n <= TILE, into the tile as float4, then +inf
    // rows up to a GROUP multiple (an infinite d2 never enters a list)
    auto stage = [&](int t0, int n) {
        __syncthreads();  // the previous tile is no longer read
        for (int c = tid; c < (n + GROUP - 1) / GROUP * GROUP; c += THREADS) {
            const float* s = p + (size_t)(t0 + c) * 3;
            tile[c] = c < n ? make_float4(s[0], s[1], s[2], 0.f)
                            : make_float4(INFINITY, INFINITY, INFINITY, 0.f);
        }
        __syncthreads();
    };

    float d[K];
    int ix[K];
#pragma unroll
    for (int j = 0; j < K; ++j) d[j] = INFINITY;

    // 1. the bound: the K-th distance among the `pre` rows around the
    // block's own (any K rows of the lane bound its K-th from above)
    float bound = INFINITY;
    if (pre > 0) {
        const int n = min(min(pre, N), TILE);
        const int t0 = min(max(row0 + THREADS / 2 - n / 2, 0), N - n);
        stage(t0, n);
        for (int c = 0; c < n; ++c) {
            const float4 t = tile[c];
            const float e = sq_dist(qx, qy, qz, t.x, t.y, t.z);
            if (e < d[K - 1]) push_distance(d, e);
        }
        // a candidate at exactly the bound may still be among the K
        bound = nextafterf(d[K - 1], INFINITY);
    }

    // 2. this split's targets, in index order
#pragma unroll
    for (int j = 0; j < K; ++j) {
        d[j] = INFINITY;
        ix[j] = 0;
    }
    float thr = bound;  // min(bound, d[K-1])
    const int first = split * tiles_per_split * TILE;
    const int last = min(N, first + tiles_per_split * TILE);
    for (int t0 = first; t0 < last; t0 += TILE) {
        const int n = min(TILE, last - t0);
        stage(t0, n);
        for (int c = 0; c < n; c += GROUP) {
            float e[GROUP];
#pragma unroll
            for (int g = 0; g < GROUP; ++g) {
                const float4 t = tile[c + g];
                e[g] = sq_dist(qx, qy, qz, t.x, t.y, t.z);
            }
#pragma unroll
            for (int w = 1; w < GROUP; w *= 2)
#pragma unroll
                for (int g = 0; g + w < GROUP; g += 2 * w)
                    e[g] = fminf(e[g], e[g + w]);
            if (e[0] < thr) {
                // the rare path: the group again, one target at a time, so
                // that one copy of the insertion is compiled
#pragma unroll 1
                for (int g = 0; g < GROUP; ++g) {
                    const float4 t = tile[c + g];
                    const float x = sq_dist(qx, qy, qz, t.x, t.y, t.z);
                    if (x < thr) {
                        insert<K, false>(d, ix, x, t0 + c + g);
                        thr = fminf(bound, d[K - 1]);
                    }
                }
            }
        }
    }

    // 3. the merge of the splits, by the last block of the row block
    if (n_split > 1) {
        const size_t rb = lane * gridDim.x + blockIdx.x;
        const size_t base = (lane * n_split + split) * (size_t)K * N;
        if (live) {
#pragma unroll
            for (int j = 0; j < K; ++j) {
                part_d[base + (size_t)j * N + row] = d[j];
                part_i[base + (size_t)j * N + row] = ix[j];
            }
        }
        __threadfence();
        __syncthreads();
        if (tid == 0) {
            const unsigned t = atomicAdd(&tickets[rb], 1u);
            s_last = (t == (unsigned)n_split - 1);
            if (s_last) tickets[rb] = 0;
        }
        __syncthreads();
        if (!s_last) return;
        __threadfence();
        if (live) {
            for (int sp = 0; sp < n_split; ++sp) {
                if (sp == split) continue;
                const size_t o = (lane * n_split + sp) * (size_t)K * N + row;
#pragma unroll 1
                for (int j = 0; j < K; ++j) {
                    const float c = __ldcg(&part_d[o + (size_t)j * N]);
                    const int ci = __ldcg(&part_i[o + (size_t)j * N]);
                    // the split's list is in key order: the rest are larger
                    if (!(c < d[K - 1] || (c == d[K - 1] && ci < ix[K - 1])))
                        break;
                    insert<K, true>(d, ix, c, ci);
                }
            }
        }
    }
    if (!live) return;
    const size_t out = (lane * (size_t)N + row) * k;
#pragma unroll
    for (int j = 0; j < K; ++j) {
        if (j < k) {
            idx_out[out + j] = ix[j];
            d2_out[out + j] = d[j];
        }
    }
}

template <int K>
int launch(const float* pts, int lanes, int N, int k, int n_split,
           int tiles_per_split, int pre, void* part_d, void* part_i,
           void* tickets, void* idx, void* d2, cudaStream_t stream) {
    const dim3 grid((N + THREADS - 1) / THREADS, n_split, lanes);
    knn_topk_kernel<K><<<grid, THREADS, 0, stream>>>(
        pts, N, k, tiles_per_split, pre, static_cast<float*>(part_d),
        static_cast<int*>(part_i), static_cast<unsigned*>(tickets),
        static_cast<int*>(idx), static_cast<float*>(d2));
    return (int)cudaGetLastError();
}

template <int K>
int occupancy(int* blocks) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, knn_topk_kernel<K>, THREADS, 0);
}

// The list length for k (knn_topk_cuda.list_length): k rounded up to a
// multiple of 4 up to 20, MAX_K above, or 0 for a k the kernel does not take.
int list_length(int k) {
    return (k < 1 || k > MAX_K) ? 0 : k > 20 ? MAX_K : (k + 3) / 4 * 4;
}

}  // namespace

// Blocks of the instantiation for k that fit on one SM of the current card.
extern "C" int lst_knn_topk_occupancy(int k, int* blocks) {
    switch (list_length(k)) {
        case 4: return occupancy<4>(blocks);
        case 8: return occupancy<8>(blocks);
        case 12: return occupancy<12>(blocks);
        case 16: return occupancy<16>(blocks);
        case 20: return occupancy<20>(blocks);
        case 32: return occupancy<32>(blocks);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int lst_knn_topk(const void* pts, int lanes, int N, int k,
                            int n_split, int tiles_per_split, int pre,
                            void* part_d, void* part_i, void* tickets,
                            void* idx, void* d2, void* stream) {
    if (lanes <= 0 || N <= 0) return (int)cudaSuccess;
    const int n_tiles = (N + TILE - 1) / TILE;
    if (n_split <= 0 || tiles_per_split <= 0 || pre < 0 ||
        (long long)n_split * tiles_per_split < n_tiles ||
        (long long)(n_split - 1) * tiles_per_split >= n_tiles ||
        (n_split > 1 && (!part_d || !part_i || !tickets)))
        return (int)cudaErrorInvalidValue;
    const float* p = static_cast<const float*>(pts);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (list_length(k)) {
#define LST_KNN_TOPK_CASE(K)                                               \
        case K: return launch<K>(p, lanes, N, k, n_split, tiles_per_split, \
                                 pre, part_d, part_i, tickets, idx, d2, s);
        LST_KNN_TOPK_CASE(4)
        LST_KNN_TOPK_CASE(8)
        LST_KNN_TOPK_CASE(12)
        LST_KNN_TOPK_CASE(16)
        LST_KNN_TOPK_CASE(20)
        LST_KNN_TOPK_CASE(32)
#undef LST_KNN_TOPK_CASE
        default: return (int)cudaErrorInvalidValue;
    }
}
