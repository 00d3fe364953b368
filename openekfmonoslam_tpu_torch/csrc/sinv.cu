// The SPD inverse S^-1 by the scaled Newton-Schulz iteration, as one
// cooperative (grid-synchronised) launch with no host synchronisation.
//
// Replaces the TPU kernel _sinv_kernel / sinv_pallas
// (openekfmonoslam_tpu/ops/sinv.py:169,177), the standalone form of
// ns_inverse_into (:68).  For S (M, M) float32 with lambda_min(S) >=
// lam_floor:
//
//   X0 = c I, c = 1.8 / (lam_floor + ||S||_inf)
//   X <- X (2I - S X)                  n_iters - f32_polish times
//   T = 2I - S X, X <- X T             the first polish step; max|T - I|
//                                      is the Newton residual (the probe)
//   probe > 0.05: X <- X0, then X <- X (2I - S X) while the step's
//                 residual max|T - I| > 5e-4, at most 128 steps
//   R = I - S X, X <- X + X R          the remaining f32_polish - 1 steps
//
// Every product is a true fp32 FMA chain (no TF32, no bf16 split, no
// padding of M: the TPU's padding leaves S^-1 unchanged).  The last polish
// step is iterative refinement: its residual R = I - S X is accumulated in
// twice the working precision (Dot2: an exact product by FMA and an exact
// two-sum per term), so the result is not held at the fp32 residual's
// rounding floor of about cond(S) eps.  A plain fp32 residual leaves the
// masked-identity-rows S of the update near the 1e-4 bound of its check;
// the refined step brings it to the fp32 representation of S^-1.
//
// Design.  The grid is at most the blocks that can be co-resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), launched cooperatively.
// Each product is a tiled fp32 GEMM over the (M, M) operands in device
// memory: 32x32 output tiles, 32-deep k-chunks staged in shared memory, a
// 2x2 register tile per thread, tiles dealt round-robin to the blocks.  At
// M = 336, S, X, X' and T are 1.8 MB and stay in the 50 MB L2.  A
// grid.sync() separates the products.  The residual max is reduced per
// block and written to that block's slot of a partial array; after the
// sync every block reduces the same slots in the same order, so the probe
// and the rescue loop are decided on the device, identically in every
// block (the barrier count stays uniform), and deterministically.  The
// partial slots are written before they are read in every phase, so the
// scratch from torch.empty needs no clearing.  NaN propagates through the
// max, and a NaN residual ends the rescue loop, as in the TPU kernel.
//
// Bound on the H100: bytes.  S is read once and S^-1 written once, 2 M^2
// 4 B = 0.90 MB at M = 336, 0.27 us at 3.35 TB/s.  The operations the
// inputs need are those of an SPD inverse over the Mu used rows (rows of
// unused slots are identity rows and need no work), about Mu^3 (Cholesky,
// triangular inverse and product, Mu^3 / 3 each): 0.57 us at 67 TFLOP/s
// with every row used, 0.03 us at the Mu of about 120 that a frame of the
// s3 map uses.  Newton-Schulz does about 28 M^3 multiply-adds over all M
// rows; the design keeps every operand in L2, so the products run from
// cache rather than device memory, and launches once, so the host adds no
// latency between the ~26 dependent products.  Their grid-wide barriers
// and the L2 latency of the k-chunks, not the bound, set its time.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TS = 32;            // output tile edge
constexpr int BK = 32;            // k-chunk depth
constexpr int THREADS = 256;      // 16 x 16 threads, 2 x 2 outputs each
constexpr int WARPS = THREADS / 32;
constexpr int MAX_RESCUE = 128;

enum Mode {
    kTwoIMinus,    // C = 2I - A B          (T = 2I - S X)
    kProduct,      // C = A B               (X' = X T)
    kResidual,     // C = I - A B in Dot2   (R = I - S X, refined)
    kAddProduct,   // C = D + A B           (X' = X + X R)
};

__device__ __forceinline__ float nan_max(float a, float b) {
    return (b > a || b != b) ? b : a;
}

// Dot2 step: (s, c) += a * b with the product's and the sum's rounding
// errors carried in c (Ogita, Rump and Oishi); no contraction by nvcc.
__device__ __forceinline__ void dot2(float& s, float& c, float a, float b) {
    const float p = __fmul_rn(a, b);
    const float q = __fmaf_rn(a, b, -p);
    const float t = __fadd_rn(s, p);
    const float z = __fsub_rn(t, s);
    const float e = __fadd_rn(__fsub_rn(s, __fsub_rn(t, z)), __fsub_rn(p, z));
    s = t;
    c = __fadd_rn(c, __fadd_rn(q, e));
}

struct Smem {
    float A[BK][TS + 1];   // A[i0 + r][k0 + k] at [k][r]
    float B[BK][TS];       // B[k0 + k][j0 + n] at [k][n]
    float red[WARPS + 1];
};

// Max over the block of v (NaN propagates); every thread gets it.
__device__ float block_max(float v, Smem& sm) {
    for (int o = 16; o > 0; o >>= 1)
        v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
    __syncthreads();
    if ((threadIdx.x & 31) == 0) sm.red[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        float m = sm.red[0];
        for (int w = 1; w < WARPS; ++w) m = nan_max(m, sm.red[w]);
        sm.red[WARPS] = m;
    }
    __syncthreads();
    return sm.red[WARPS];
}

// Max of the grid's partial slots, written before the last grid.sync();
// every block reads them in the same order and gets the same value.
__device__ float grid_max(const float* partial, Smem& sm) {
    if (threadIdx.x == 0) {
        float m = __ldcg(partial);
        for (int b = 1; b < (int)gridDim.x; ++b)
            m = nan_max(m, __ldcg(partial + b));
        sm.red[WARPS] = m;
    }
    __syncthreads();
    const float m = sm.red[WARPS];
    __syncthreads();
    return m;
}

// One product over all output tiles of the grid.  With ``track``, returns
// this block's max |C - I| (kTwoIMinus only), else 0.  Operands written
// inside this launch are read with __ldcg (L2, never a stale L1 line).
template <int MODE>
__device__ float gemm(const float* A, const float* B, const float* D,
                      float* C, int M, bool track, Smem& sm) {
    const int tiles = (M + TS - 1) / TS;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float local = 0.0f;
    for (int tile = blockIdx.x; tile < tiles * tiles; tile += gridDim.x) {
        const int i0 = (tile / tiles) * TS, j0 = (tile % tiles) * TS;
        float acc[2][2] = {}, cmp[2][2] = {};
        for (int k0 = 0; k0 < M; k0 += BK) {
            for (int e = threadIdx.x; e < TS * BK; e += THREADS) {
                const int r = e / BK, kk = e % BK;
                const int i = i0 + r, k = k0 + kk;
                sm.A[kk][r] = (i < M && k < M) ? __ldcg(A + (size_t)i * M + k)
                                               : 0.0f;
                const int kb = e / TS, n = e % TS;
                const int k2 = k0 + kb, j = j0 + n;
                sm.B[kb][n] = (k2 < M && j < M)
                                  ? __ldcg(B + (size_t)k2 * M + j) : 0.0f;
            }
            __syncthreads();
#pragma unroll 8
            for (int kk = 0; kk < BK; ++kk) {
                const float a[2] = {sm.A[kk][ty * 2], sm.A[kk][ty * 2 + 1]};
                const float b[2] = {sm.B[kk][tx * 2], sm.B[kk][tx * 2 + 1]};
#pragma unroll
                for (int r = 0; r < 2; ++r)
#pragma unroll
                    for (int s = 0; s < 2; ++s) {
                        if (MODE == kResidual)
                            dot2(acc[r][s], cmp[r][s], a[r], b[s]);
                        else
                            acc[r][s] = __fmaf_rn(a[r], b[s], acc[r][s]);
                    }
            }
            __syncthreads();
        }
        for (int r = 0; r < 2; ++r) {
            const int i = i0 + ty * 2 + r;
            for (int s = 0; s < 2; ++s) {
                const int j = j0 + tx * 2 + s;
                if (i >= M || j >= M) continue;
                const size_t o = (size_t)i * M + j;
                const float d = (i == j) ? 1.0f : 0.0f;
                float v;
                if (MODE == kTwoIMinus) {
                    v = __fsub_rn(2.0f * d, acc[r][s]);
                    if (track) local = nan_max(local, fabsf(__fsub_rn(v, d)));
                } else if (MODE == kProduct) {
                    v = acc[r][s];
                } else if (MODE == kResidual) {
                    v = __fsub_rn(__fsub_rn(d, acc[r][s]), cmp[r][s]);
                } else {
                    v = __fadd_rn(__ldcg(D + o), acc[r][s]);
                }
                C[o] = v;
            }
        }
    }
    return local;
}

__device__ void fill_scaled_identity(float* X, int M, float c) {
    const size_t n = (size_t)M * M;
    for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < n;
         e += (size_t)gridDim.x * THREADS)
        X[e] = (e / M == e % M) ? c : 0.0f;
}

// X0 = ``out``, X1 = ``xs``: the iterate ping-pongs between them and ends
// in ``out``.  ``partial`` holds one float per block; info[0] gets the
// number of rescue steps taken (0: no rescue).
__global__ void __launch_bounds__(THREADS)
sinv_ns(const float* __restrict__ S, float* out, float* xs, float* T,
        float* partial, int* info, int M, float lam_floor, int n_main,
        int n_refine) {
    __shared__ Smem sm;
    cg::grid_group grid = cg::this_grid();
    float* X[2] = {out, xs};
    int cur = 0;

    // ||S||_inf: one warp a row
    float local = 0.0f;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int i = blockIdx.x * WARPS + warp; i < M; i += gridDim.x * WARPS) {
        float s = 0.0f;
        for (int j = lane; j < M; j += 32) s += fabsf(S[(size_t)i * M + j]);
        for (int o = 16; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
        local = nan_max(local, s);
    }
    local = block_max(local, sm);
    if (threadIdx.x == 0) partial[blockIdx.x] = local;
    grid.sync();
    const float c = 1.8f / (lam_floor + grid_max(partial, sm));
    fill_scaled_identity(X[cur], M, c);
    grid.sync();

    for (int it = 0; it < n_main; ++it) {
        gemm<kTwoIMinus>(S, X[cur], nullptr, T, M, false, sm);
        grid.sync();
        gemm<kProduct>(X[cur], T, nullptr, X[cur ^ 1], M, false, sm);
        grid.sync();
        cur ^= 1;
    }

    // the first polish step, whose T is the probe
    local = block_max(gemm<kTwoIMinus>(S, X[cur], nullptr, T, M, true, sm),
                      sm);
    if (threadIdx.x == 0) partial[blockIdx.x] = local;
    grid.sync();
    const bool bad = grid_max(partial, sm) > 0.05f;
    gemm<kProduct>(X[cur], T, nullptr, X[cur ^ 1], M, false, sm);
    grid.sync();
    cur ^= 1;

    int rescue = 0;
    if (bad) {
        fill_scaled_identity(X[cur], M, c);
        grid.sync();
        float res = 1.0f;
        while (res > 5e-4f && rescue < MAX_RESCUE) {
            local = block_max(
                gemm<kTwoIMinus>(S, X[cur], nullptr, T, M, true, sm), sm);
            if (threadIdx.x == 0) partial[blockIdx.x] = local;
            grid.sync();
            res = grid_max(partial, sm);
            gemm<kProduct>(X[cur], T, nullptr, X[cur ^ 1], M, false, sm);
            grid.sync();
            cur ^= 1;
            ++rescue;
        }
    }

    for (int it = 0; it < n_refine; ++it) {
        gemm<kResidual>(S, X[cur], nullptr, T, M, false, sm);
        grid.sync();
        gemm<kAddProduct>(X[cur], T, X[cur], X[cur ^ 1], M, false, sm);
        grid.sync();
        cur ^= 1;
    }

    if (cur == 1) {
        const size_t n = (size_t)M * M;
        for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < n;
             e += (size_t)gridDim.x * THREADS)
            out[e] = __ldcg(xs + e);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) info[0] = rescue;
}

}  // namespace

// out (M, M) = S^-1; xs and T (M, M) and partial (one float per TS x TS
// output tile, which is at least the grid's block count) are caller-owned
// scratch, info (1,) int32.  Returns the launch's cudaError_t, or 0.
EKF_EXPORT int ekf_sinv(const float* S, float* out, float* xs, float* T,
                        float* partial, int* info, int M, float lam_floor,
                        int n_iters, int f32_polish, void* stream) {
    // the co-resident block count is queried once; later calls (possibly
    // inside a CUDA graph capture) only launch
    static int max_blocks = 0;
    int err = 0;
    if (max_blocks == 0) {
        int device = 0, sms = 0, per_sm = 0, coop = 0;
        if ((err = (int)cudaGetDevice(&device))) return err;
        if ((err = (int)cudaDeviceGetAttribute(
                 &coop, cudaDevAttrCooperativeLaunch, device)))
            return err;
        if (!coop) return (int)cudaErrorNotSupported;
        if ((err = (int)cudaDeviceGetAttribute(
                 &sms, cudaDevAttrMultiProcessorCount, device)))
            return err;
        if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &per_sm, sinv_ns, THREADS, 0)))
            return err;
        max_blocks = per_sm * sms;
        if (max_blocks < 1) return (int)cudaErrorInvalidConfiguration;
    }
    if (M < 1 || f32_polish < 1 || n_iters < f32_polish)
        return (int)cudaErrorInvalidValue;
    const int tiles = (M + TS - 1) / TS;
    const int blocks = tiles * tiles < max_blocks ? tiles * tiles : max_blocks;
    int n_main = n_iters - f32_polish, n_refine = f32_polish - 1;
    void* args[] = {(void*)&S, (void*)&out, (void*)&xs, (void*)&T,
                    (void*)&partial, (void*)&info, (void*)&M,
                    (void*)&lam_floor, (void*)&n_main, (void*)&n_refine};
    if ((err = (int)cudaLaunchCooperativeKernel(
             (const void*)sinv_ns, dim3(blocks), dim3(THREADS), args, 0,
             (cudaStream_t)stream)))
        return err;
    return ekf_last_error();
}
