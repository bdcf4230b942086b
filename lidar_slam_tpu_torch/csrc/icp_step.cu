// One Gauss-Newton iteration of the point-to-plane ICP as one Hopper
// (sm_90a) kernel, with a plain C interface loaded through ctypes by
// lidar_slam_tpu_torch/ops/icp_cuda.py.
//
// Build (done on first use by icp_cuda.py, keyed on this file's hash, with
// the flags of csrc/knn.cu):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//        -shared -Xcompiler -fPIC -o libicp_step.so icp_step.cu
//
// What it replaces. No Pallas kernel: it fuses the body of the lax.while_loop
// of lidar_slam_tpu/ops/icp.py:196-219 (and the coarse fori_loop body at
// :170-176) after the correspondence search, which XLA fuses on the TPU and
// which the port ran as 270 eager ATen launches an iteration, 5.5 ms of
// host time (NVIDIA H100 80GB HBM3; ops/icp.py:_plane_error,
// solve_point_to_plane, linalg.solve_psd_small, se3.exp_so3 / from_rt,
// lane_compose and the torch.where bookkeeping).
// The correspondence kernels (K1, K2 in csrc/knn.cu) stay as they are: this
// kernel reads their output.
//
// One launch does, for every lane at once (grid: blocks_per_lane x lanes):
//  1. the row pass: per source row its current point cur = R src + t (read
//     from `cur`, which the APPLY mode wrote), the matched target row and
//     normal (K1: strided rows of its packed output; K2: gathered here from
//     the int32 index), the residual d = (matched - cur) . n and the
//     Jacobian row J = [cur x n, n]; it sums the upper triangle of J^T W J
//     (21), J^T W d (6), sum w d^2 and sum w, and stores no Jacobian;
//  2. a deterministic reduction: each block writes its 29 partial sums to a
//     fixed slot, and the lane's last block (a ticket counter, as in K1's
//     merge) sums them in block order. Blocks per lane depend on the row
//     count N alone (BLOCK_ROWS rows a block), never on the lane count or
//     the card, so a lane rounds the same alone and in a batch;
//  3. the solve and update, by one thread of that last block: the error
//     sqrt(sum w d^2 / denom), the convergence test, A / denom + damping I
//     and rhs / denom, the unrolled Cholesky-Crout and two substitutions in
//     ops/linalg.py's operation order (the same 1e-12 clamp), exp_so3 and
//     from_rt, the left compose, and the masked updates of T, prev_err,
//     converged, it and the error history that ops/icp.py's loop makes;
//  4. the loop flag: the last lane to finish (a second ticket) writes
//     flags = [any lane active, any lane needing a final pass], which the
//     host reads once an iteration instead of a reduction launch.
// Modes: APPLY writes cur = T src; COARSE composes every lane (no test, as
// the coarse warm start does); STEP is one loop iteration; FINAL writes
// the final error (and its history slot) of the lanes that need the final
// pass, or with no loop state the plain error of every lane.
//
// Arithmetic. float32 throughout, --fmad=false, no tensor cores: each
// elementwise step rounds as PyTorch's eager float32 ops do; only the sums'
// order differs from the plain version (ops/icp.py), so results agree to a
// few ulps of the sums, not bit for bit.
//
// The bound on this card: bytes. A row reads cur (12 B), its weight (1 B),
// the matched point and normal (24 B; K1's packed row or K2's index, 4 B,
// plus the gathered rows) once: about 40 B a row, so 32,768 rows are 1.3 MB,
// 0.4 us at 3.35 TB/s; the 29 sums are ~60 FP32 operations a row, further
// below the ALUs' rate. The kernel is far from both: its time is the
// launch, one pass over the rows per block with 4 independent rows a
// thread in flight, a block-wide shuffle reduction, and one thread's
// serial 6x6 solve (~300 dependent operations): 8-9 us a launch at 1 x
// 4,096 to 3 x 32,768 rows on an H100. What the design does about that is
// to make the whole iteration one launch: the host's ~20 us a launch, not
// the device, bounded the eager version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int RPT = 4;                       // rows a thread
constexpr int BLOCK_ROWS = THREADS * RPT;    // rows a block
constexpr int NQ = 29;                       // 21 + 6 + sum w d^2 + sum w
constexpr int PART = 32;                     // floats a block's slot
constexpr float JITTER = 1e-12f;             // ops/linalg.py:_JITTER

enum Mode { APPLY = 0, COARSE = 1, STEP = 2, FINAL = 3 };

}  // namespace

// The launch's arguments; mirrored by ops/icp_cuda.py:IcpStepArgs. Lane
// strides are in elements (0 for a source shared by every lane).
struct IcpStepArgs {
    int mode, lanes, rows;
    int max_it, hist_len;
    float damping, min_error, tolerance;
    const float* src;               // (B, N, 3) rows, APPLY's input
    long long src_lane;
    float* cur;                     // (B, N, 3) contiguous
    const unsigned char* mask;      // (B, N) bool, rows contiguous
    long long mask_lane;
    const float* pts;               // matched points or, with idx, targets
    long long pts_lane, pts_row;
    const float* nrm;               // their normals
    long long nrm_lane, nrm_row;
    const int* idx;                 // (B, N) int32 or null (row-aligned)
    float* T;                       // (B, 4, 4)
    int* it;                        // (B,) or null (no loop state)
    float* prev_err;                // (B,)
    unsigned char* converged;       // (B,) bool
    float* hist;                    // (B, hist_len)
    float* err_out;                 // (B,) FINAL's error
    float* part;                    // (B, blocks, PART) scratch
    unsigned* tickets;              // B lane tickets + 1: 0 in, 0 out
    int* flags;                     // [any active, any needing a final pass]
};

namespace {

// delta = [exp_so3(x[0:3]) | x[3:6]] (ops/se3.py:exp_so3, from_rt), then
// T = delta T (lane_compose), in place.
__device__ void compose_delta(const float (&x)[6], float* T) {
    const float w0 = x[0], w1 = x[1], w2 = x[2];
    const float theta2 = (w0 * w0 + w1 * w1) + w2 * w2;
    const bool tiny = theta2 < 1e-12f;
    const float theta = sqrtf(tiny ? 1.0f : theta2);
    const float A = tiny ? 1.0f - theta2 / 6.0f : sinf(theta) / theta;
    const float half = theta * 0.5f;
    const float hs = tiny ? 1.0f - theta2 / 24.0f : sinf(half) / half;
    const float Bc = 0.5f * hs * hs;
    const float W[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
    float D[4][4];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            const float ww = (W[i][0] * W[0][j] + W[i][1] * W[1][j]) +
                             W[i][2] * W[2][j];
            D[i][j] = ((i == j ? 1.0f : 0.0f) + A * W[i][j]) + Bc * ww;
        }
        D[i][3] = x[3 + i];
    }
    D[3][0] = D[3][1] = D[3][2] = 0.0f;
    D[3][3] = 1.0f;
    float out[16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            out[4 * i + j] = ((D[i][0] * T[j] + D[i][1] * T[4 + j]) +
                              D[i][2] * T[8 + j]) + D[i][3] * T[12 + j];
#pragma unroll
    for (int k = 0; k < 16; ++k) T[k] = out[k];
}

// The mean-normalised, damped normal equations from the 29 sums, solved by
// ops/linalg.py:solve_psd_small's unrolled Cholesky-Crout.
__device__ void solve_step(const float* s, float denom, float damping,
                           float (&x)[6]) {
    float A[6][6], b[6];
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j, ++k) {
            const float v = s[k] / denom;
            A[i][j] = A[j][i] = i == j ? v + damping : v;
        }
#pragma unroll
    for (int i = 0; i < 6; ++i) b[i] = s[21 + i] / denom;
    float L[6][6];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j) {
            float v = A[i][j];
#pragma unroll
            for (int p = 0; p < j; ++p) v = v - L[i][p] * L[j][p];
            // torch.clamp(v, min=JITTER): a NaN stays NaN
            L[i][j] = i == j ? sqrtf(v < JITTER ? JITTER : v) : v / L[j][j];
        }
    float y[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        float v = b[i];
#pragma unroll
        for (int p = 0; p < i; ++p) v = v - L[i][p] * y[p];
        y[i] = v / L[i][i];
    }
#pragma unroll
    for (int i = 5; i >= 0; --i) {
        float v = y[i];
#pragma unroll
        for (int p = i + 1; p < 6; ++p) v = v - L[p][i] * x[p];
        x[i] = v / L[i][i];
    }
}

// The lane's last block, thread 0: the error, the solve and the updates.
__device__ void finish_lane(const IcpStepArgs& a, int lane, const float* s) {
    const float denom = s[28] < 1.0f ? 1.0f : s[28];
    const float err = sqrtf(s[27] / denom);
    float* T = a.T + (size_t)lane * 16;
    if (a.mode == FINAL) {
        if (a.it == nullptr) {
            a.err_out[lane] = err;
            return;
        }
        const int it = a.it[lane];
        const bool need = !(a.converged[lane] && it > 0);
        const float f = need ? err : a.prev_err[lane];
        a.err_out[lane] = f;
        a.hist[(size_t)lane * a.hist_len + it] = f;
        return;
    }
    if (a.mode == COARSE) {
        float x[6];
        solve_step(s, denom, a.damping, x);
        compose_delta(x, T);
        return;
    }
    const int it = a.it[lane];
    if (!(it < a.max_it) || a.converged[lane]) return;   // frozen lane
    const bool conv = err < a.min_error ||
                      fabsf(a.prev_err[lane] - err) < a.tolerance;
    float* hist = a.hist + (size_t)lane * a.hist_len;
    hist[it] = err;
    if (conv) {
        hist[it + 1] = err;   // a converged exit's final error
    } else {
        float x[6];
        solve_step(s, denom, a.damping, x);
        compose_delta(x, T);
    }
    a.prev_err[lane] = err;
    a.converged[lane] = conv;
    a.it[lane] = it + 1;
}

__global__ void __launch_bounds__(THREADS) icp_step_kernel(const IcpStepArgs a)
{
    __shared__ float s_warp[THREADS / 32][NQ];
    __shared__ float s_sum[NQ];
    __shared__ bool s_last;

    const int tid = threadIdx.x, wid = tid >> 5, lid = tid & 31;
    const int blk = blockIdx.x, nb = gridDim.x, lane = blockIdx.y;
    const int N = a.rows;
    const size_t lrow = (size_t)lane * N;   // the lane's first row

    if (a.mode == APPLY) {
        const float* T = a.T + (size_t)lane * 16;
        const float* src = a.src + lane * a.src_lane;
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
            const int r = blk * BLOCK_ROWS + j * THREADS + tid;
            if (r >= N) continue;
            const float s0 = src[(size_t)r * 3], s1 = src[(size_t)r * 3 + 1],
                        s2 = src[(size_t)r * 3 + 2];
            float* c = a.cur + (lrow + r) * 3;
#pragma unroll
            for (int i = 0; i < 3; ++i)
                c[i] = ((s0 * T[4 * i] + s1 * T[4 * i + 1]) + s2 * T[4 * i + 2]) +
                       T[4 * i + 3];
        }
        return;
    }

    // 1. the row pass: 4 independent rows a thread
    float acc[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q] = 0.0f;
    const unsigned char* mask = a.mask + lane * a.mask_lane;
    const float* pts = a.pts + lane * a.pts_lane;
    const float* nrm = a.nrm + lane * a.nrm_lane;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        const int r = blk * BLOCK_ROWS + j * THREADS + tid;
        if (r >= N || !mask[r]) continue;   // weight 0 adds nothing
        const float* c = a.cur + (lrow + r) * 3;
        const float c0 = c[0], c1 = c[1], c2 = c[2];
        const long long g = a.idx ? (long long)a.idx[lrow + r] : r;
        const float* m = pts + g * a.pts_row;
        const float* n = nrm + g * a.nrm_row;
        const float n0 = n[0], n1 = n[1], n2 = n[2];
        const float d = ((m[0] - c0) * n0 + (m[1] - c1) * n1) + (m[2] - c2) * n2;
        const float J[6] = {c1 * n2 - c2 * n1, c2 * n0 - c0 * n2,
                            c0 * n1 - c1 * n0, n0, n1, n2};
        int k = 0;
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
            for (int q = p; q < 6; ++q, ++k) acc[k] += J[p] * J[q];
#pragma unroll
        for (int p = 0; p < 6; ++p) acc[21 + p] += J[p] * d;
        acc[27] += d * d;
        acc[28] += 1.0f;
    }

    // 2. the block's sums (a butterfly leaves every lane of a warp with the
    // same bits), then the warps' in order
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        float v = acc[q];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        acc[q] = v;
    }
    if (lid == 0) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) s_warp[wid][q] = acc[q];
    }
    __syncthreads();
    float v = 0.0f;
    if (tid < NQ) {
        v = s_warp[0][tid];
#pragma unroll
        for (int w = 1; w < THREADS / 32; ++w) v += s_warp[w][tid];
    }
    if (nb > 1) {
        float* part = a.part + (size_t)lane * nb * PART;
        if (tid < NQ) part[(size_t)blk * PART + tid] = v;
        __threadfence();
        __syncthreads();
        if (tid == 0) {
            const unsigned t = atomicAdd(&a.tickets[lane], 1u);
            s_last = (t == (unsigned)nb - 1);
            if (s_last) a.tickets[lane] = 0;
        }
        __syncthreads();
        if (!s_last) return;
        __threadfence();
        if (tid < NQ) {
            v = __ldcg(&part[tid]);
            for (int b = 1; b < nb; ++b) v += __ldcg(&part[(size_t)b * PART + tid]);
        }
    }
    if (tid < NQ) s_sum[tid] = v;
    __syncthreads();
    if (tid != 0) return;

    // 3. the lane's solve and update
    finish_lane(a, lane, s_sum);
    if (a.mode != STEP) return;

    // 4. the last lane to finish writes the loop's flags
    __threadfence();
    const unsigned t = atomicAdd(&a.tickets[a.lanes], 1u);
    if (t != (unsigned)a.lanes - 1) return;
    a.tickets[a.lanes] = 0;
    __threadfence();
    const volatile int* its = a.it;
    const volatile unsigned char* conv = a.converged;
    int active = 0, need = 0;
    for (int l = 0; l < a.lanes; ++l) {
        const int i = its[l];
        const bool c = conv[l] != 0;
        active |= (i < a.max_it) && !c;
        need |= !(c && i > 0);
    }
    a.flags[0] = active;
    a.flags[1] = need;
}

}  // namespace

extern "C" int lst_icp_step(const IcpStepArgs* args, void* stream) {
    const IcpStepArgs& a = *args;
    if (a.lanes <= 0 || a.rows <= 0) return (int)cudaSuccess;
    bool ok = a.lanes <= 65535 && a.mode >= APPLY && a.mode <= FINAL &&
              a.cur && a.T;
    if (a.mode == APPLY) {
        ok = ok && a.src;
    } else {
        ok = ok && a.mask && a.pts && a.nrm && a.part && a.tickets;
    }
    const bool loop_state = a.it && a.prev_err && a.converged && a.hist &&
                            a.max_it >= 0 && a.hist_len >= a.max_it + 1;
    if (a.mode == STEP) ok = ok && loop_state && a.flags;
    if (a.mode == FINAL) ok = ok && a.err_out && (!a.it || loop_state);
    if (!ok) return (int)cudaErrorInvalidValue;
    const dim3 grid((a.rows + BLOCK_ROWS - 1) / BLOCK_ROWS, a.lanes);
    icp_step_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}
