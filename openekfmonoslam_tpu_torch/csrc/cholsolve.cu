// The SPD solve X = S^-1 B by right-looking blocked Cholesky, as one
// cooperative (grid-synchronised) launch with no host synchronisation.
//
// Replaces the TPU kernel _cholsolve_kernel / chol_solve_pallas
// (openekfmonoslam_tpu/ops/cholsolve.py:102,151).  The algorithm is the
// same, with block size BS = 64 and the pivot clamp max(pivot, 1e-30):
//
//   for each 64-column block k:
//       L_kk = chol(A_kk), W_k = L_kk^-1        one CTA, shared memory
//       A[>k, k] = A[>k, k] W_k^T               the panel, all CTAs
//       A[>k, >k] -= panel panel^T              the trailing update
//   Y_k = W_k (B_k - L[k, <k] Y[<k])            forward, block by block
//   X_k = W_k^T (Y_k - L[>k, k]^T X[>k])        backward
//
// For S (M, M) and B (M, K) float32, any M, K >= 1: the last block is
// ragged and handled in the kernel, where the TPU wrapper padded M to 64
// and K to 128.  Every product is a true fp32 FMA chain (no TF32): the TPU
// kernel's 1.9e-2 error at default MXU precision came from bf16 passes.
//
// Design.  The grid is at most the blocks that can be co-resident
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), launched cooperatively.
// The factor works on a copy of S in device memory (its lower triangle
// becomes L; the upper triangle is never read).  For each block column,
// CTA 0 factors the diagonal block and inverts it in shared memory (L and
// W together are 33 KB) while the others wait at a grid.sync(); then
// every CTA takes 32-row strips of the panel, then 32x32 tiles of the
// trailing update's lower triangle, each phase behind a grid.sync().  The
// two triangular solves need no grid barrier, because the columns of B
// are independent: after one more grid.sync() each CTA takes strips of 4
// columns of B and runs the whole forward and backward substitution for
// them, block by block through the stored W_k, with L read from device
// memory in 32-deep chunks (at M = 336, L is 0.45 MB and stays in the
// 50 MB L2).  X holds Y in between.  Everything written in this launch is
// read with __ldcg (L2), never from a stale L1 line.
//
// Bound on the H100: operations.  S, B and X are moved once, 4 (M^2 +
// 2 M K) bytes, and the function needs M^3 / 3 + 2 M^2 K operations: at
// (M, K) = (192, 640), the shape of the s3 update's S^-1 (H P), 1.13 MB
// (0.34 us at 3.35 TB/s) and 49.5 MFLOP (0.74 us at 67 TFLOP/s), bound by
// operations at 0.74 us; at (336, 1024), the large map, 3.64 us by
// operations.  This design does not approach that bound: the diagonal
// steps are 64-step sequential loops in one CTA (a Cholesky column, then
// a column of the inverse per thread), ceil(M / 64) of them in a row with
// the card otherwise idle, and 3 grid barriers per block column.  It is
// the simple, correct kernel; a faster one would factor the diagonal
// blocks recursively and overlap them with the trailing update.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BS = 64;            // Cholesky block size
constexpr int THREADS = 256;
constexpr int TS = 32;            // trailing-update output tile edge
constexpr int PR = 32;            // panel rows a step
constexpr int STRIP = 4;          // columns of B a solve strip
constexpr int LC = 32;            // depth of the solve's L chunks
constexpr float PIVOT_FLOOR = 1e-30f;

union Smem {
    struct {
        float L[BS][BS + 1];
        float W[BS][BS + 1];
    } diag;
    struct {
        float W[BS][BS + 1];
        float A[PR][BS + 1];
    } panel;
    struct {
        float Pi[TS][BS + 1];
        float Pj[TS][BS + 1];
    } trail;
    struct {
        float W[BS][BS + 1];
        float L[BS * (LC + 1)];   // [BS][LC + 1] forward, [LC][BS + 1] back
        float X[LC][STRIP];
        float R[BS][STRIP];
    } solve;
};

// CTA 0: factor the diagonal block A[o:o+bs, o:o+bs] (its lower triangle)
// into L_kk, written back into A, and its inverse W_k, written to W as a
// full 64x64 block (zero outside bs x bs).
__device__ void factor_diag(float* A, float* W, int M, int o, int bs,
                            Smem& sm) {
    float(*L)[BS + 1] = sm.diag.L;
    float(*Wi)[BS + 1] = sm.diag.W;
    const int tid = threadIdx.x;
    for (int e = tid; e < BS * BS; e += THREADS) {
        const int i = e / BS, j = e % BS;
        L[i][j] = (i < bs && j <= i)
                      ? __ldcg(A + (size_t)(o + i) * M + o + j) : 0.0f;
        Wi[i][j] = 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < bs; ++j) {
        const float d = __frsqrt_rn(fmaxf(L[j][j], PIVOT_FLOOR));
        __syncthreads();
        if (tid >= j && tid < bs) L[tid][j] *= d;
        __syncthreads();
        // the block's trailing lower triangle: rows i > j, columns j < l <= i
        const int n = bs - j - 1;
        for (int e = tid; e < n * n; e += THREADS) {
            const int i = j + 1 + e / n, l = j + 1 + e % n;
            if (l <= i) L[i][l] = __fmaf_rn(-L[i][j], L[l][j], L[i][l]);
        }
        __syncthreads();
    }
    // W = L^-1 by forward substitution, one column a thread:
    // W[i][c] = (delta_ic - L[i][:i] W[:i][c]) / L[i][i]
    if (tid < bs) {
        const int c = tid;
        for (int i = 0; i < bs; ++i) {
            float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
            int l = 0;
            for (; l + 3 < i; l += 4) {
                a0 = __fmaf_rn(L[i][l], Wi[l][c], a0);
                a1 = __fmaf_rn(L[i][l + 1], Wi[l + 1][c], a1);
                a2 = __fmaf_rn(L[i][l + 2], Wi[l + 2][c], a2);
                a3 = __fmaf_rn(L[i][l + 3], Wi[l + 3][c], a3);
            }
            for (; l < i; ++l) a0 = __fmaf_rn(L[i][l], Wi[l][c], a0);
            const float acc = (a0 + a1) + (a2 + a3);
            Wi[i][c] = ((i == c ? 1.0f : 0.0f) - acc) / L[i][i];
        }
    }
    __syncthreads();
    for (int e = tid; e < BS * BS; e += THREADS) {
        const int i = e / BS, j = e % BS;
        W[e] = Wi[i][j];
        if (i < bs && j <= i) A[(size_t)(o + i) * M + o + j] = L[i][j];
    }
}

// The panel A[r:M, o:o+bs] <- A[r:M, o:o+bs] W_k^T, in 32-row strips.
__device__ void panel(float* A, const float* W, int M, int o, int bs, int r,
                      int m, Smem& sm) {
    const int chunks = (m + PR - 1) / PR;
    if ((int)blockIdx.x >= chunks) return;
    const int tid = threadIdx.x;
    for (int e = tid; e < BS * BS; e += THREADS)
        sm.panel.W[e / BS][e % BS] = __ldcg(W + e);
    for (int p = blockIdx.x; p < chunks; p += gridDim.x) {
        const int r0 = r + p * PR;
        __syncthreads();
        for (int e = tid; e < PR * BS; e += THREADS) {
            const int rr = e / BS, l = e % BS, row = r0 + rr;
            sm.panel.A[rr][l] = (row < M && l < bs)
                                    ? __ldcg(A + (size_t)row * M + o + l)
                                    : 0.0f;
        }
        __syncthreads();
        for (int e = tid; e < PR * BS; e += THREADS) {
            const int rr = e / BS, c = e % BS, row = r0 + rr;
            float acc = 0.0f;
            for (int l = 0; l < bs; ++l)     // W[c][l] = 0 for l > c
                acc = __fmaf_rn(sm.panel.A[rr][l], sm.panel.W[c][l], acc);
            if (row < M && c < bs) A[(size_t)row * M + o + c] = acc;
        }
    }
}

// The trailing update A[r:M, r:M] -= P P^T, P = A[r:M, o:o+bs], over the
// 32x32 tiles of its lower triangle; 2x2 outputs a thread.
__device__ void trailing(float* A, int M, int o, int bs, int r, int m,
                         Smem& sm) {
    const int T = (m + TS - 1) / TS;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    for (int t = blockIdx.x; t < T * T; t += gridDim.x) {
        const int ti = t / T, tj = t % T;
        if (tj > ti) continue;
        const int i0 = r + ti * TS, j0 = r + tj * TS;
        __syncthreads();
        for (int e = tid; e < TS * BS; e += THREADS) {
            const int rr = e / BS, l = e % BS;
            sm.trail.Pi[rr][l] =
                (l < bs && i0 + rr < M)
                    ? __ldcg(A + (size_t)(i0 + rr) * M + o + l) : 0.0f;
            sm.trail.Pj[rr][l] =
                (l < bs && j0 + rr < M)
                    ? __ldcg(A + (size_t)(j0 + rr) * M + o + l) : 0.0f;
        }
        __syncthreads();
        float acc[2][2] = {};
        for (int l = 0; l < bs; ++l) {
            const float a[2] = {sm.trail.Pi[ty * 2][l],
                                sm.trail.Pi[ty * 2 + 1][l]};
            const float b[2] = {sm.trail.Pj[tx * 2][l],
                                sm.trail.Pj[tx * 2 + 1][l]};
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
                for (int v = 0; v < 2; ++v)
                    acc[u][v] = __fmaf_rn(a[u], b[v], acc[u][v]);
        }
        for (int u = 0; u < 2; ++u) {
            const int i = i0 + ty * 2 + u;
            for (int v = 0; v < 2; ++v) {
                const int j = j0 + tx * 2 + v;
                if (i < M && j <= i) {
                    const size_t off = (size_t)i * M + j;
                    A[off] = __fsub_rn(__ldcg(A + off), acc[u][v]);
                }
            }
        }
    }
}

__device__ void load_w(const float* W, Smem& sm) {
    for (int e = threadIdx.x; e < BS * BS; e += THREADS)
        sm.solve.W[e / BS][e % BS] = __ldcg(W + e);
}

// Rows [l0, l0 + LC) of this strip's columns of X into shared memory.
__device__ void load_x_chunk(const float* X, int M, int K, int c0, int l0,
                             Smem& sm) {
    const int tid = threadIdx.x;
    if (tid < LC * STRIP) {
        const int l = tid / STRIP, cc = tid % STRIP;
        sm.solve.X[l][cc] = (l0 + l < M && c0 + cc < K)
                                ? __ldcg(X + (size_t)(l0 + l) * K + c0 + cc)
                                : 0.0f;
    }
}

// Both triangular solves for strips of STRIP columns of B; thread (i, c)
// owns row i of the current block and column c of the strip.
__device__ void solve(const float* B, float* X, const float* A,
                      const float* Wg, int M, int K, Smem& sm) {
    const int strips = (K + STRIP - 1) / STRIP;
    const int nb = (M + BS - 1) / BS;
    const int tid = threadIdx.x, i = tid / STRIP, c = tid % STRIP;
    float* Lc = sm.solve.L;
    for (int s = blockIdx.x; s < strips; s += gridDim.x) {
        const int c0 = s * STRIP, col = c0 + c;
        const bool colok = col < K;
        // forward: Y_k = W_k (B_k - L[k, <k] Y[<k]), Y kept in X
        for (int k = 0; k < nb; ++k) {
            const int o = k * BS, bs = min(BS, M - o);
            float acc = 0.0f;
            for (int l0 = 0; l0 < o; l0 += LC) {
                __syncthreads();
                for (int e = tid; e < BS * LC; e += THREADS) {
                    const int ii = e / LC, l = e % LC;
                    Lc[ii * (LC + 1) + l] =
                        ii < bs ? __ldcg(A + (size_t)(o + ii) * M + l0 + l)
                                : 0.0f;
                }
                load_x_chunk(X, M, K, c0, l0, sm);
                __syncthreads();
                for (int l = 0; l < LC; ++l)
                    acc = __fmaf_rn(Lc[i * (LC + 1) + l], sm.solve.X[l][c],
                                    acc);
            }
            __syncthreads();
            load_w(Wg + (size_t)k * BS * BS, sm);
            sm.solve.R[i][c] = (i < bs && colok)
                                   ? __fsub_rn(B[(size_t)(o + i) * K + col],
                                               acc)
                                   : 0.0f;
            __syncthreads();
            if (i < bs && colok) {
                float y = 0.0f;
                for (int l = 0; l < bs; ++l)    // W[i][l] = 0 for l > i
                    y = __fmaf_rn(sm.solve.W[i][l], sm.solve.R[l][c], y);
                X[(size_t)(o + i) * K + col] = y;
            }
        }
        // backward: X_k = W_k^T (Y_k - L[>k, k]^T X[>k])
        for (int k = nb - 1; k >= 0; --k) {
            const int o = k * BS, bs = min(BS, M - o), r = o + bs;
            float acc = 0.0f;
            for (int l0 = r; l0 < M; l0 += LC) {
                __syncthreads();
                for (int e = tid; e < LC * BS; e += THREADS) {
                    const int l = e / BS, ii = e % BS;
                    Lc[l * (BS + 1) + ii] =
                        (l0 + l < M && ii < bs)
                            ? __ldcg(A + (size_t)(l0 + l) * M + o + ii) : 0.0f;
                }
                load_x_chunk(X, M, K, c0, l0, sm);
                __syncthreads();
                for (int l = 0; l < LC; ++l)
                    acc = __fmaf_rn(Lc[l * (BS + 1) + i], sm.solve.X[l][c],
                                    acc);
            }
            __syncthreads();
            load_w(Wg + (size_t)k * BS * BS, sm);
            sm.solve.R[i][c] =
                (i < bs && colok)
                    ? __fsub_rn(__ldcg(X + (size_t)(o + i) * K + col), acc)
                    : 0.0f;
            __syncthreads();
            if (i < bs && colok) {
                float x = 0.0f;
                for (int l = 0; l < bs; ++l)    // W[l][i] = 0 for l < i
                    x = __fmaf_rn(sm.solve.W[l][i], sm.solve.R[l][c], x);
                X[(size_t)(o + i) * K + col] = x;
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS)
cholsolve_blocked(const float* __restrict__ S, const float* __restrict__ B,
                  float* X, float* A, float* W, int M, int K) {
    __shared__ Smem sm;
    cg::grid_group grid = cg::this_grid();
    const size_t n = (size_t)M * M;
    for (size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x; e < n;
         e += (size_t)gridDim.x * THREADS)
        A[e] = S[e];
    grid.sync();
    const int nb = (M + BS - 1) / BS;
    for (int k = 0; k < nb; ++k) {
        const int o = k * BS, bs = min(BS, M - o), r = o + bs, m = M - r;
        float* Wk = W + (size_t)k * BS * BS;
        if (blockIdx.x == 0) factor_diag(A, Wk, M, o, bs, sm);
        grid.sync();
        if (m == 0) break;
        panel(A, Wk, M, o, bs, r, m, sm);
        grid.sync();
        trailing(A, M, o, bs, r, m, sm);
        grid.sync();
    }
    solve(B, X, A, W, M, K, sm);
}

}  // namespace

// X (M, K) = S^-1 B; A (M, M) and W (ceil(M / 64) * 64 * 64) are
// caller-owned scratch.  Returns the launch's cudaError_t, or 0.
EKF_EXPORT int ekf_cholsolve(const float* S, const float* B, float* X,
                             float* A, float* W, int M, int K, void* stream) {
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
                 &per_sm, cholsolve_blocked, THREADS, 0)))
            return err;
        max_blocks = per_sm * sms;
        if (max_blocks < 1) return (int)cudaErrorInvalidConfiguration;
    }
    if (M < 1 || K < 1) return (int)cudaErrorInvalidValue;
    const int tiles = (M + TS - 1) / TS;
    const int strips = (K + STRIP - 1) / STRIP;
    const int want = tiles * tiles > strips ? tiles * tiles : strips;
    const int blocks = want < max_blocks ? want : max_blocks;
    void* args[] = {(void*)&S, (void*)&B, (void*)&X, (void*)&A, (void*)&W,
                    (void*)&M, (void*)&K};
    if ((err = (int)cudaLaunchCooperativeKernel(
             (const void*)cholsolve_blocked, dim3(blocks), dim3(THREADS),
             args, 0, (cudaStream_t)stream)))
        return err;
    return ekf_last_error();
}
