// Hand-written Hopper (sm_90a) kernels for the correspondence searches of
// the SLAM main path, with a plain C interface loaded through ctypes by
// lidar_slam_tpu_torch/ops/knn_cuda.py.
//
// Build (done on first use by knn_cuda.py, keyed on this file's hash):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//        -shared -Xcompiler -fPIC -o libknn.so knn.cu
//
// The contract. Both kernels evaluate the squared distance in the difference
// form ((dx*dx + dy*dy) + dz*dz) with explicitly rounded intrinsics (and
// --fmad=false), so every d2 is bit-identical to the plain PyTorch version
// (ops/knn.py:sq_dist), and both return the FIRST index of the minimum, as
// torch.min and the TPU kernels' argmin do. Indices and distances can be
// compared exactly. The |s|^2 + |t|^2 - 2 s.t matrix form would round
// differently, so the tensor cores are out: these kernels run on the FP32
// ALUs, and their design is about keeping those fed.
//
// The bound. One distance evaluation is 8 FP32 instructions (3 subtractions,
// 3 products, 2 additions), none of them fusable under the contract, so the
// card starts at most SMs x 128 lanes x clock of them a second: 132 x 128 x
// 1.98 GHz = 33.5 T/s on an H100 SXM, half its 67 TFLOP/s FP32 figure. The
// bytes are far below that for both kernels (stated at each).
//
// What the inner loop does about it (scan_groups, shared by both kernels):
//  - register tiling: a thread owns R = 4 source rows and reads the targets
//    from a shared-memory SoA tile as float4, so three broadcast shared loads
//    serve 16 evaluations (128 arithmetic instructions) instead of one; the
//    arithmetic pipes, not the shared-memory port, are the busy unit;
//  - four independent (min, where) chains per thread instead of one
//    dependent compare chain;
//  - the next float4 of each plane is loaded before the arithmetic on the
//    current one (register double buffering of the shared loads);
//  - the running minimum is kept per GROUP of consecutive targets (16 in K2,
//    4 in K1) with one fminf per evaluation, and (best, best group) is
//    updated once per group with a strict '<'. The exact index is recovered
//    at the end by re-evaluating the one winning group and taking the first
//    element whose d2 equals the minimum (first_equal): the same arithmetic
//    gives the same bits. That is 9.2 (K2) or 9.75 (K1) instructions per
//    evaluation instead of 11 for a compare-and-select per target. K1's
//    groups are short because its threads re-read their winning groups from
//    shared memory at scattered addresses, where 16 scalar reads a row cost
//    more bank conflicts than the longer groups saved.
//
// The merge that keeps the first index. A row's search is split over threads
// and blocks, and the partial results are merged with a 64-bit key
//     key = (bits(d2) << 32) | index
// reduced with an unsigned min. d2 is a sum of squares: never negative, never
// -0, so its float bits order as unsigned integers, and among equal d2 the
// smaller index wins: the first-index rule, exactly, in any merge order.
// Inside a block K1 takes the min over shared-memory arrays. Across blocks
// both kernels write per-block keys to a scratch array in device memory, and
// the last block to finish (a ticket counter) reduces them.
//
// Every C entry point returns the launch's error code; the Python wrapper
// raises when it is not 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 4;          // source rows per thread
constexpr float SENTINEL = 1.0e6f;
constexpr int QUANT = 128;       // window starts are multiples of this
constexpr int LUT_BINS = 4096;

typedef unsigned long long u64;

__device__ __forceinline__ float sq_dist(float sx, float sy, float sz,
                                         float tx, float ty, float tz) {
    const float dx = __fsub_rn(sx, tx);
    const float dy = __fsub_rn(sy, ty);
    const float dz = __fsub_rn(sz, tz);
    return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                     __fmul_rn(dz, dz));
}

__device__ __forceinline__ u64 make_key(float d2, int index) {
    return ((u64)__float_as_uint(d2) << 32) | (unsigned)index;
}

// Scan n_groups groups of GROUP targets (a multiple of 4) from a 16-byte
// aligned SoA tile in shared memory, ascending. Group g of the tile has the
// id g0 + g. A row's (best, bg) moves only on a strictly smaller group
// minimum, so bg is the FIRST group that holds the row's minimum.
template <int GROUP>
__device__ __forceinline__ void scan_groups(
    const float* tx, const float* ty, const float* tz, int n_groups, int g0,
    const float (&sx)[ROWS], const float (&sy)[ROWS], const float (&sz)[ROWS],
    float (&best)[ROWS], int (&bg)[ROWS])
{
    const float4* x4 = reinterpret_cast<const float4*>(tx);
    const float4* y4 = reinterpret_cast<const float4*>(ty);
    const float4* z4 = reinterpret_cast<const float4*>(tz);
    // the next float4 of each plane is loaded before the arithmetic on the
    // current one, so the shared-memory latency hides behind 128 instructions
    const int last = n_groups * (GROUP / 4) - 1;
    float4 X = x4[0], Y = y4[0], Z = z4[0];
#pragma unroll(16 / GROUP)
    for (int g = 0; g < n_groups; ++g) {
        float m[ROWS];
#pragma unroll
        for (int j = 0; j < ROWS; ++j) m[j] = INFINITY;
#pragma unroll
        for (int u = 0; u < GROUP / 4; ++u) {
            const int nxt = min(g * (GROUP / 4) + u + 1, last);
            const float4 Xn = x4[nxt], Yn = y4[nxt], Zn = z4[nxt];
#pragma unroll
            for (int j = 0; j < ROWS; ++j) {
                m[j] = fminf(m[j], sq_dist(sx[j], sy[j], sz[j], X.x, Y.x, Z.x));
                m[j] = fminf(m[j], sq_dist(sx[j], sy[j], sz[j], X.y, Y.y, Z.y));
                m[j] = fminf(m[j], sq_dist(sx[j], sy[j], sz[j], X.z, Y.z, Z.z));
                m[j] = fminf(m[j], sq_dist(sx[j], sy[j], sz[j], X.w, Y.w, Z.w));
            }
            X = Xn;
            Y = Yn;
            Z = Zn;
        }
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            if (m[j] < best[j]) {
                best[j] = m[j];
                bg[j] = g0 + g;
            }
        }
    }
}

// First position in a group of GROUP targets (16-byte aligned, shared or
// global memory) whose d2 equals `best` bit for bit.
template <int GROUP>
__device__ __forceinline__ int first_equal(const float* tx, const float* ty,
                                           const float* tz, float sx, float sy,
                                           float sz, float best) {
    const float4* x4 = reinterpret_cast<const float4*>(tx);
    const float4* y4 = reinterpret_cast<const float4*>(ty);
    const float4* z4 = reinterpret_cast<const float4*>(tz);
    int found = 0;
#pragma unroll
    for (int u = GROUP / 4 - 1; u >= 0; --u) {
        const float4 X = x4[u], Y = y4[u], Z = z4[u];
        if (sq_dist(sx, sy, sz, X.w, Y.w, Z.w) == best) found = 4 * u + 3;
        if (sq_dist(sx, sy, sz, X.z, Y.z, Z.z) == best) found = 4 * u + 2;
        if (sq_dist(sx, sy, sz, X.y, Y.y, Z.y) == best) found = 4 * u + 1;
        if (sq_dist(sx, sy, sz, X.x, Y.x, Z.x) == best) found = 4 * u;
    }
    return found;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// K2: exact brute-force 1-NN.
//
// Replaces _nn1_kernel / nn1_pallas (lidar_slam_tpu/ops/knn_pallas.py:41-140).
// The TPU kernel walks a sequential (source tile, target tile) grid and keeps
// a running (min, argmin) in its output block. Here the grid is
// (source row blocks, target splits, lanes), all parallel.
//
// Bound on this card: operations. lanes x S x T evaluations of 8 FP32
// instructions at 33.5 T/s: 3 x 4,096 x 32,768 evaluations are 96 us. The
// bytes (sources, the SoA target planes, the outputs) are 1.4 MB, under a
// microsecond of HBM time.
//
// Design:
//  - the target is laid out ONCE per ICP call by the wrapper (masked rows at
//    the 1e6 sentinel, transposed to SoA x/y/z planes, padded with +inf to a
//    tile multiple: an infinite d2 never wins), so every query is this one
//    launch and every tile copy is 16-byte aligned;
//  - grid fill: a block owns 512 source rows (128 threads x 4 rows) and one
//    split of the target; the wrapper sizes the splits so that about two
//    blocks an SM are in flight (264 for 3 lanes, 256 for 1 lane at
//    S = 4,096, T = 32,768, on 132 SMs);
//  - staging: a NN1_STAGES-deep ring of NN1_TILE-target tiles in shared
//    memory filled by cp.async (16 bytes a copy, three copies a thread a
//    tile), one __syncthreads per tile; the copy of tile i+1 overlaps the
//    arithmetic on tile i;
//  - inner loop: scan_groups (register tiling, float4, group minima);
//  - merge: each block writes its rows' keys to part[lane][split][row], then
//    takes a ticket; the block that draws the last ticket of its (lane, row
//    block) reduces the splits' keys with an unsigned min and writes idx and
//    d2, and resets the ticket for the next launch. One launch, no output
//    initialised beforehand, any order of arrival.
// ---------------------------------------------------------------------------

constexpr int NN1_THREADS = 128;
constexpr int NN1_TILE = 512;
constexpr int NN1_STAGES = 2;
constexpr int NN1_GROUP = 16;
constexpr int NN1_BLOCK_ROWS = NN1_THREADS * ROWS;

__global__ void __launch_bounds__(NN1_THREADS)
nn1_kernel(const float* __restrict__ src,   // (B, S, 3)
           const float* __restrict__ soa,   // (B, 3, Tp): masked 1e6, pads inf
           int S, int Tp, int tiles_per_split,
           u64* __restrict__ part,          // (B, splits, S) scratch keys
           unsigned* __restrict__ tickets,  // (B, row blocks): 0 in, 0 out
           int* __restrict__ idx_out,       // (B, S)
           float* __restrict__ d2_out)      // (B, S)
{
    __shared__ __align__(16) float tile[NN1_STAGES][3][NN1_TILE];
    __shared__ bool s_last;

    const int tid = threadIdx.x;
    const size_t lane = blockIdx.z;
    const int split = blockIdx.y, n_split = gridDim.y;
    const float* s = src + lane * (size_t)S * 3;
    const float* planes = soa + lane * (size_t)Tp * 3;
    const int tile0 = split * tiles_per_split;
    const int nt = min(tiles_per_split, Tp / NN1_TILE - tile0);

    float sx[ROWS], sy[ROWS], sz[ROWS], best[ROWS];
    int bg[ROWS], row[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        row[j] = blockIdx.x * NN1_BLOCK_ROWS + j * NN1_THREADS + tid;
        const bool live = row[j] < S;
        sx[j] = live ? s[(size_t)row[j] * 3 + 0] : 0.f;
        sy[j] = live ? s[(size_t)row[j] * 3 + 1] : 0.f;
        sz[j] = live ? s[(size_t)row[j] * 3 + 2] : 0.f;
        best[j] = INFINITY;
        bg[j] = tile0 * (NN1_TILE / NN1_GROUP);
    }

    // 16 bytes a copy: NN1_TILE / 4 copies a plane, three planes a tile
    auto stage_tile = [&](int i) {
        if (i < nt) {
            const size_t base = (size_t)(tile0 + i) * NN1_TILE;
#pragma unroll
            for (int c = tid; c < 3 * (NN1_TILE / 4); c += NN1_THREADS) {
                const int p = c / (NN1_TILE / 4), o = 4 * (c % (NN1_TILE / 4));
                cp_async16(&tile[i % NN1_STAGES][p][o],
                           planes + (size_t)p * Tp + base + o);
            }
        }
        cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < NN1_STAGES - 1; ++i) stage_tile(i);
    for (int i = 0; i < nt; ++i) {
        cp_async_wait<NN1_STAGES - 2>();  // tile i has landed (this thread's)
        __syncthreads();                  // ... and everyone's; tile i-1 is free
        stage_tile(i + NN1_STAGES - 1);
        const int st = i % NN1_STAGES;
        scan_groups<NN1_GROUP>(
            tile[st][0], tile[st][1], tile[st][2], NN1_TILE / NN1_GROUP,
            (tile0 + i) * (NN1_TILE / NN1_GROUP), sx, sy, sz, best, bg);
    }

    u64 key[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        const float* g = planes + (size_t)bg[j] * NN1_GROUP;
        const int k = first_equal<NN1_GROUP>(g, g + Tp, g + 2 * (size_t)Tp,
                                             sx[j], sy[j], sz[j], best[j]);
        key[j] = make_key(best[j], bg[j] * NN1_GROUP + k);
    }

    if (n_split > 1) {
        const size_t rb = lane * gridDim.x + blockIdx.x;
#pragma unroll
        for (int j = 0; j < ROWS; ++j)
            if (row[j] < S)
                part[(lane * n_split + split) * (size_t)S + row[j]] = key[j];
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
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            if (row[j] >= S) continue;
            for (int sp = 0; sp < n_split; ++sp) {
                if (sp == split) continue;
                const u64 k = __ldcg(
                    &part[(lane * n_split + sp) * (size_t)S + row[j]]);
                key[j] = min(key[j], k);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
        if (row[j] >= S) continue;
        idx_out[lane * S + row[j]] = (int)(key[j] & 0xffffffffull);
        d2_out[lane * S + row[j]] =
            fmaxf(__uint_as_float((unsigned)(key[j] >> 32)), 0.f);
    }
}

// ---------------------------------------------------------------------------
// K1: slab-window fused 1-NN + correspondence gather, window starts included.
//
// Replaces _match_slab_kernel / _match_slab_call
// (lidar_slam_tpu/ops/knn_pallas.py:228-310) and the per-call glue around it
// (_pad_rows, _slab_starts_lut, the d2 clamp). A tile of `ts` consecutive
// source rows (x-sorted clouds) searches one window of `window` consecutive
// rows of the x-sorted packed target; the matched point and normal are a
// direct 32-byte load of packed row start + argmin (the TPU kernel needed a
// bf16x3 one-hot matmul for this gather), so they are bit-identical to
// tgt[idx] and normals[idx].
//
// Bound on this card: operations. lanes x S x window evaluations of 8 FP32
// instructions at 33.5 T/s: 4,096 x 4,096 evaluations are 4 us a lane. The
// bytes (the sources, the packed target, the LUT and the outputs, each once)
// are 1.3 MB a lane, under a microsecond of HBM time. At this size a chain
// of dependent global loads (source x, LUT, window, scratch keys, matched
// row) weighs as much as the arithmetic.
//
// Design:
//  - lanes: a batched engine runs B sequences in lockstep, each ICP lane
//    with its own target, LUT and scale. The lane is the grid's z
//    dimension: one launch serves every lane, and each lane's blocks read
//    and write only that lane's rows, LUT, scratch keys and ticket counters,
//    so a lane's result is bit-identical to a one-lane launch on it (the
//    TPU kernel ran the lanes one after another, sequential_vmap);
//  - grid fill: the tile's window is cut into chunks, one block each (8
//    chunks of 512 targets at window 4,096: 16 tiles x 8 = 128 blocks for
//    132 SMs, where one block a tile filled 16);
//  - starts in the kernel: every block computes its tile's window start
//    itself: the block-wide minimum of the rows' x (rows past S count as
//    the sentinel, as the padded rows of the plain version do), then
//    floor(((min - margin) - lo) * inv_h) in that order with rounded
//    intrinsics, clamped to the LUT, lut[b] rounded down to a QUANT
//    multiple and clamped to [0, padded_T - window]: the arithmetic of
//    ops/knn_cuda.py:_slab_starts_lut, whose result it must equal. lo,
//    inv_h and lut are device pointers; nothing is read back to the host.
//    The start is written to starts_out for the card check;
//  - staging: the block's chunk goes from the packed (Tp, 8) rows (one
//    float4 load a target) to an SoA x/y/z tile in shared memory, padded
//    with +inf to the chunk length;
//  - inner loop: 256 threads = 4 column groups x 64 row slots; a thread
//    scans a quarter of the chunk for 4 rows with scan_groups;
//  - merge: the four column groups store their keys (d2 bits, window
//    column) side by side in shared memory; after a __syncthreads one
//    thread a row takes their min and writes it to part[tile][chunk][row]
//    in device memory; the block then takes a ticket of its tile, and the
//    block that draws the last one takes the min over the chunks, gathers
//    the packed row and stores qn, d2 (clamped at 0) and idx for rows below
//    S, and resets the ticket. One launch; the tickets are zeroed once per
//    target, not per launch.
//    A thread block cluster a tile, merging through distributed shared
//    memory, was built and measured first. It lost: the card places
//    clusters of 8 blocks on 15 groups of 8 SMs (120 of 132 SMs), so two of
//    the 16 clusters shared their SMs and ran twice as long as the rest.
//    Plain blocks spread over 128 SMs.
// ---------------------------------------------------------------------------

constexpr int MS_THREADS = 256;
constexpr int MS_COLGROUPS = 4;
constexpr int MS_SLOTS = MS_THREADS / MS_COLGROUPS;   // row slots per pass
constexpr int MS_PASS_ROWS = MS_SLOTS * ROWS;
constexpr int MS_GROUP = 4;

__global__ void __launch_bounds__(MS_THREADS)
match_slab_kernel(const float* __restrict__ src,       // (B, S, 3)
                  int S,
                  const float* __restrict__ tgt8,      // (B, padded_T, 8)
                  int padded_T,
                  const long long* __restrict__ lut,   // (B, LUT_BINS)
                  const float* __restrict__ lo_p,      // (B,)
                  const float* __restrict__ inv_h_p,   // (B,)
                  float margin, int ts, int window, int chunk,
                  u64* __restrict__ part_g,            // (B, tiles, chunks, ts)
                  unsigned* __restrict__ tickets,      // (B, tiles): 0 in, 0 out
                  float* __restrict__ qn_out,          // (B, S, 8)
                  float* __restrict__ d2_out,          // (B, S)
                  int* __restrict__ idx_out,           // (B, S)
                  int* __restrict__ starts_out)        // (B, tiles)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int tsp = (ts + 1) & ~1;                  // keeps the floats aligned
    u64* part = reinterpret_cast<u64*>(smem_raw);   // (MS_COLGROUPS, tsp)
    float* wx = reinterpret_cast<float*>(part + MS_COLGROUPS * tsp);
    float* wy = wx + chunk;
    float* wz = wy + chunk;
    __shared__ float s_min[MS_THREADS / 32];
    __shared__ int s_start;
    __shared__ bool s_last;

    const int crank = blockIdx.x, n_chunk = gridDim.x;
    const int tile = blockIdx.y, n_tiles = gridDim.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int row0 = tile * ts;

    // this block's ICP lane: every pointer below is that lane's
    const size_t il = blockIdx.z;
    src += il * (size_t)S * 3;
    tgt8 += il * (size_t)padded_T * 8;
    lut += il * (size_t)LUT_BINS;
    lo_p += il;
    inv_h_p += il;
    part_g += il * (size_t)n_tiles * n_chunk * ts;
    tickets += il * (size_t)n_tiles;
    qn_out += il * (size_t)S * 8;
    d2_out += il * (size_t)S;
    idx_out += il * (size_t)S;
    starts_out += il * (size_t)n_tiles;

    // 1. the tile's window start
    float mn = INFINITY;
    for (int r = tid; r < ts; r += MS_THREADS) {
        const int row = row0 + r;
        mn = fminf(mn, row < S ? src[(size_t)row * 3] : SENTINEL);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, o));
    if (lane == 0) s_min[warp] = mn;
    __syncthreads();
    if (tid == 0) {
        float m = s_min[0];
        for (int w = 1; w < MS_THREADS / 32; ++w) m = fminf(m, s_min[w]);
        float b = floorf(__fmul_rn(__fsub_rn(__fsub_rn(m, margin), *lo_p),
                                   *inv_h_p));
        b = fminf(fmaxf(b, 0.f), (float)(LUT_BINS - 1));
        long long st = (lut[(int)b] / QUANT) * QUANT;
        const long long hi = max(padded_T - window, 0);
        st = min(max(st, 0ll), hi);
        s_start = (int)st;
        if (crank == 0) starts_out[tile] = (int)st;
    }
    __syncthreads();
    const int start = s_start;

    // 2. stage this block's chunk of the window
    const int c0 = crank * chunk;
    for (int k = tid; k < chunk; k += MS_THREADS) {
        const int col = c0 + k;
        float4 p = make_float4(INFINITY, INFINITY, INFINITY, 0.f);
        if (col < window)
            p = *reinterpret_cast<const float4*>(
                tgt8 + (size_t)(start + col) * 8);
        wx[k] = p.x;
        wy[k] = p.y;
        wz[k] = p.z;
    }
    __syncthreads();

    // 3. scan: warp -> (column group, row slots), a quarter chunk x 4 rows
    const int cg_i = warp % MS_COLGROUPS;
    const int slot = (warp / MS_COLGROUPS) * 32 + lane;
    const int q = chunk / MS_COLGROUPS;             // a multiple of MS_GROUP
    for (int r0 = 0; r0 < ts; r0 += MS_PASS_ROWS) {
        float sx[ROWS], sy[ROWS], sz[ROWS], best[ROWS];
        int bg[ROWS], r[ROWS];
        bool live[ROWS];
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            r[j] = r0 + j * MS_SLOTS + slot;
            const size_t row = (size_t)row0 + r[j];
            live[j] = r[j] < ts && row < (size_t)S;
            sx[j] = live[j] ? src[row * 3 + 0] : 0.f;
            sy[j] = live[j] ? src[row * 3 + 1] : 0.f;
            sz[j] = live[j] ? src[row * 3 + 2] : 0.f;
            best[j] = INFINITY;
            bg[j] = cg_i * (q / MS_GROUP);
        }
        scan_groups<MS_GROUP>(wx + cg_i * q, wy + cg_i * q, wz + cg_i * q,
                              q / MS_GROUP, cg_i * (q / MS_GROUP), sx, sy, sz,
                              best, bg);
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            if (!live[j]) continue;
            const int g = bg[j] * MS_GROUP;
            const int k = first_equal<MS_GROUP>(wx + g, wy + g, wz + g, sx[j],
                                                sy[j], sz[j], best[j]);
            part[cg_i * tsp + r[j]] = make_key(best[j], c0 + g + k);
        }
    }

    // 4. merge the column groups; with one chunk a tile that is the answer
    __syncthreads();
    u64* mine = part_g + ((size_t)tile * n_chunk + crank) * ts;
    for (int r = tid; r < ts; r += MS_THREADS) {
        if ((size_t)row0 + r >= (size_t)S) continue;
        u64 key = part[r];
#pragma unroll
        for (int c = 1; c < MS_COLGROUPS; ++c)
            key = min(key, part[c * tsp + r]);
        mine[r] = key;
    }
    if (n_chunk > 1) {
        __threadfence();
        __syncthreads();
        if (tid == 0) {
            const unsigned t = atomicAdd(&tickets[tile], 1u);
            s_last = (t == (unsigned)n_chunk - 1);
            if (s_last) tickets[tile] = 0;
        }
        __syncthreads();
        if (!s_last) return;
        __threadfence();
    }

    // 5. the tile's last block: min over the chunks, gather, store
    const u64* keys = part_g + (size_t)tile * n_chunk * ts;
    for (int r = tid; r < ts; r += MS_THREADS) {
        const size_t row = (size_t)row0 + r;
        if (row >= (size_t)S) continue;
        u64 key = __ldcg(&keys[r]);
        for (int b = 1; b < n_chunk; ++b)
            key = min(key, __ldcg(&keys[(size_t)b * ts + r]));
        const int g = start + (int)(key & 0xffffffffull);
        const float4* p = reinterpret_cast<const float4*>(tgt8 + (size_t)g * 8);
        float4* o = reinterpret_cast<float4*>(qn_out + row * 8);
        o[0] = p[0];
        o[1] = p[1];
        d2_out[row] = fmaxf(__uint_as_float((unsigned)(key >> 32)), 0.f);
        idx_out[row] = g;
    }
}

}  // namespace

extern "C" int lst_nn1(const void* src, const void* soa, int lanes, int S,
                       int Tp, int n_split, int tiles_per_split, void* part,
                       void* tickets, void* idx, void* d2, void* stream) {
    if (lanes <= 0 || S <= 0) return (int)cudaSuccess;
    if (Tp <= 0 || Tp % NN1_TILE || n_split <= 0 ||
        (long long)n_split * tiles_per_split < Tp / NN1_TILE ||
        (long long)(n_split - 1) * tiles_per_split >= Tp / NN1_TILE)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((S + NN1_BLOCK_ROWS - 1) / NN1_BLOCK_ROWS, n_split, lanes);
    nn1_kernel<<<grid, NN1_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), static_cast<const float*>(soa), S, Tp,
        tiles_per_split, static_cast<u64*>(part),
        static_cast<unsigned*>(tickets), static_cast<int*>(idx),
        static_cast<float*>(d2));
    return (int)cudaGetLastError();
}

extern "C" int lst_match_slab(const void* src, int lanes, int S,
                              const void* tgt8, int padded_T,
                              const void* lut, const void* lo,
                              const void* inv_h, float margin, int ts,
                              int window, int n_chunk, int chunk, void* part,
                              void* tickets, void* qn, void* d2, void* idx,
                              void* starts, void* stream) {
    if (lanes <= 0 || S <= 0) return (int)cudaSuccess;
    if (lanes > 65535 || ts <= 0 || window <= 0 || window > padded_T ||
        n_chunk <= 0 || chunk % (MS_COLGROUPS * MS_GROUP) ||
        (long long)n_chunk * chunk < window)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)((ts + 1) & ~1) * MS_COLGROUPS * sizeof(u64) +
                        (size_t)3 * chunk * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            match_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid(n_chunk, (S + ts - 1) / ts, lanes);
    match_slab_kernel<<<grid, MS_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), S, static_cast<const float*>(tgt8),
        padded_T, static_cast<const long long*>(lut),
        static_cast<const float*>(lo), static_cast<const float*>(inv_h),
        margin, ts, window, chunk, static_cast<u64*>(part),
        static_cast<unsigned*>(tickets), static_cast<float*>(qn),
        static_cast<float*>(d2), static_cast<int*>(idx),
        static_cast<int*>(starts));
    return (int)cudaGetLastError();
}
