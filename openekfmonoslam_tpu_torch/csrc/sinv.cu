// The SPD inverse S^-1 by a compacted Cholesky factorization, as a memset
// and six launches on one stream with no host synchronisation.
//
// Replaces the TPU kernel _sinv_kernel / sinv_pallas
// (openekfmonoslam_tpu/ops/sinv.py:169,177), the standalone form of
// ns_inverse_into (:68): S^-1 for S (M, M) float32 SPD.  The TPU kernel
// iterates Newton-Schulz on the MXU; here the work is a factorization over
// the rows that carry data (spd_core.cuh), in six launches:
//
//   (a) sinv_flags      rows of S across CTAs: row k is an identity row
//                       when row k and column k of S are exactly e_k (every
//                       unused row of the masked S filter/update.kalman_xp
//                       builds); the flags of the others are set (on a
//                       zeroed array: one memset before)
//   (b) sinv_factor     one CTA: the other Mu rows are compacted and
//                       S_u = L L^T factored
//   (c) sinv_solve      column slabs of I across CTAs: W = L^-1 by blocked
//                       forward substitution with the diagonal blocks'
//                       inverses (a slab's rows above its first block are
//                       zero and skipped)
//   (d) sinv_product<0> X = W^T W = S_u^-1, tiled, over the rows of W
//                       below both output tiles
//   (e) sinv_product<1> R = I - S_u X with each term accumulated in twice
//                       the working precision (Dot2: an exact product by
//                       FMA and an exact two-sum per term; Ogita, Rump and
//                       Oishi)
//   (f) sinv_product<2> X + X R scattered to out[idx, idx]; the identity
//                       rows and columns of S give those of S^-1
//
// The refinement step is the Newton-Schulz kernel's last polish step: its
// refined residual holds the result at the fp32 representation of S^-1
// rather than at the fp32 residual's floor of about cond(S) eps.  Every
// product is a true fp32 FMA chain (no TF32, no bf16 split).  A
// non-positive pivot is counted in info[0] (0 for an SPD S); nothing reads
// it back on the path.
//
// Bound on the H100: bytes.  S is read once and S^-1 written once, 2 M^2
// 4 B = 0.90 MB at M = 336, 0.27 us at 3.35 TB/s; the operations an SPD
// inverse over the Mu used rows needs, about Mu^3 flops (Cholesky,
// triangular inverse and product, Mu^3 / 6 multiply-adds each), are
// 0.03 us at the Mu of about 120 of the large map.  The design is latency
// bound: (b) takes ceil(Mu / 32) panels of four block barriers on one SM,
// (c) ceil(Mu / 32) block rows in every CTA, (d)-(f) are one tiled pass
// each over Mu x Mu; with all M rows used (a dense S) the one-SM
// factorization's M^3 / 6 multiply-adds dominate.
//
// B streams' S stacked (a batched launch, BATCHED): the same memset and six
// launches with the stream as blockIdx.y, so B factor CTAs run side by side
// on B SMs.  Each stream has its own scratch block (L, Dinv, W, X, R, Y at
// their single-stream offsets, fs floats a stream), its own idx and pos (M
// ints each) and meta (2 ints), and compacts its own mask; one memset zeroes
// the B streams' flags.  Each stream runs exactly the single-stream code on
// its own pointers, so its bits are those of its single launch.  The single
// launch (BATCHED false) compiles the offsets out.

#include "spd_core.cuh"

namespace {

using spd::NB;

constexpr int SLAB = 8;                  // columns of I a solve CTA takes
constexpr int SOLVE_THREADS = 256;
constexpr int SOLVE_SMEM_MAX = 96 * 1024;
constexpr int TS = 16;                   // output tile of the products
constexpr int FLAG_ROWS = 8;             // rows of S a flags CTA scans

enum Product { kGram, kResidual, kRefine };

// The stream of a batched launch's CTA.
template <bool BATCHED>
__device__ __forceinline__ long long stream_index() {
    if constexpr (BATCHED) return blockIdx.y;
    return 0;
}

// Dot2 step: (s, c) += a * b with the product's and the sum's rounding
// errors carried in c; no contraction by nvcc.
__device__ __forceinline__ void dot2(float& s, float& c, float a, float b) {
    const float p = __fmul_rn(a, b);
    const float q = __fmaf_rn(a, b, -p);
    const float t = __fadd_rn(s, p);
    const float z = __fsub_rn(t, s);
    const float e = __fadd_rn(__fsub_rn(s, __fsub_rn(t, z)), __fsub_rn(p, z));
    s = t;
    c = __fadd_rn(c, __fadd_rn(q, e));
}

// flags[i] = 1 when row i or column i of S differs from e_i; flags zeroed
// before the launch.  A warp a row of S, FLAG_ROWS rows a CTA.
template <bool BATCHED>
__global__ void __launch_bounds__(FLAG_ROWS * 32)
sinv_flags(const float* __restrict__ S, int* __restrict__ flags, int M) {
    if constexpr (BATCHED) {
        const long long s = stream_index<BATCHED>();
        S += s * M * M;
        flags += s * M;
    }
    const int i = blockIdx.x * FLAG_ROWS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (i >= M) return;
    const float* row = S + (long long)i * M;
    bool any = false;
    for (int j = lane; j < M; j += 32)
        if (row[j] != (i == j ? 1.0f : 0.0f)) {
            any = true;
            flags[j] = 1;
        }
    if (__any_sync(spd::FULL, any) && lane == 0) flags[i] = 1;
}

// meta: [0] Mu, [1] non-positive pivots (info); L packed tri(M) floats;
// Dinv ceil(M / NB) NB x NB floats; idx and pos M ints each, pos holding
// the flags of sinv_flags on entry
template <bool BATCHED>
__global__ void __launch_bounds__(spd::FACTOR_THREADS)
sinv_factor(const float* __restrict__ S, float* L, float* __restrict__ Dinv,
            int* __restrict__ idx, int* __restrict__ pos,
            int* __restrict__ meta, int M, int smem_bytes, long long fs) {
    extern __shared__ float4 smem4[];
    if constexpr (BATCHED) {
        const long long s = stream_index<BATCHED>();
        S += s * M * M;
        L += s * fs;
        Dinv += s * fs;
        idx += s * M;
        pos += s * M;
        meta += 2 * s;
    }
    // each thread reads the flag of its row before it writes the row's
    // compact index over it
    spd::compact_and_factor((float*)smem4, smem_bytes,
                            [&](int r) { return pos[r] != 0; }, M, S, 0.0f,
                            L, Dinv, idx, pos, meta);
}

// One CTA a slab of SLAB columns c0.. of the identity: W = L^-1 E, written
// to W (Mu x Mu, row-major, compact indices).
template <bool BATCHED>
__global__ void __launch_bounds__(SOLVE_THREADS)
sinv_solve(const float* __restrict__ L, const float* __restrict__ Dinv,
           const int* __restrict__ meta, float* __restrict__ W,
           float* __restrict__ Yglobal, int in_smem, long long fs) {
    extern __shared__ float smem[];
    __shared__ spd::SolveSmem sm;
    if constexpr (BATCHED) {
        const long long s = stream_index<BATCHED>();
        L += s * fs;
        Dinv += s * fs;
        W += s * fs;
        Yglobal += s * fs;
        meta += 2 * s;
    }
    const int n = meta[0];
    const int c0 = blockIdx.x * SLAB;
    if (c0 >= n) return;
    const int tid = threadIdx.x;
    float* Y = in_smem ? smem : Yglobal + (long long)blockIdx.x * n * SLAB;
    for (int e = tid; e < n * SLAB; e += SOLVE_THREADS) {
        const int k = e / SLAB, w = e % SLAB;
        Y[e] = (k == c0 + w) ? 1.0f : 0.0f;
    }
    __syncthreads();
    spd::forward_solve<SLAB, SOLVE_THREADS>(Y, n, (c0 / NB) * NB, L, Dinv,
                                            sm);
    for (int e = tid; e < n * SLAB; e += SOLVE_THREADS) {
        const int k = e / SLAB, w = e % SLAB;
        if (c0 + w < n) W[(long long)k * n + c0 + w] = Y[e];
    }
}

// One TS x TS tile of a Mu x Mu product over compact indices, a thread an
// output:
//   kGram      X = W^T W, over the rows k >= max(i, j) (W is lower)
//   kResidual  R = I - S_u X in Dot2 (S_u gathered from S through idx)
//   kRefine    X + X R, scattered to out[idx, idx]; every CTA also writes
//              a share of the identity rows and columns of out
// The grid covers ceil(M / TS)^2 tiles; those beyond Mu exit early.  A
// batched launch offsets S and out by M x M a stream, the scratch (A, B
// and the other C) by fs.
template <int MODE, bool BATCHED>
__global__ void __launch_bounds__(TS * TS)
sinv_product(const float* __restrict__ S, const float* __restrict__ A,
             const float* __restrict__ B, float* __restrict__ C,
             const int* __restrict__ idx, const int* __restrict__ pos,
             const int* __restrict__ meta, int M, long long fs) {
    __shared__ float As[TS][TS + 1];     // As[k][i] = A(i0 + i, k0 + k)
    __shared__ float Bs[TS][TS];         // Bs[k][j] = B(k0 + k, j0 + j)
    if constexpr (BATCHED) {
        const long long s = stream_index<BATCHED>();
        S += s * M * M;
        if (MODE != kResidual) A += s * fs;
        B += s * fs;
        C += MODE == kRefine ? s * M * M : s * fs;
        idx += s * M;
        pos += s * M;
        meta += 2 * s;
    }
    const int n = meta[0];
    const int tx = threadIdx.x % TS, ty = threadIdx.x / TS;
    if (MODE == kRefine) {
        // identity rows and columns of S^-1, a row of out a block at a time
        for (int i = blockIdx.x; i < M; i += gridDim.x) {
            const bool row_id = pos[i] < 0;
            for (int j = threadIdx.x; j < M; j += TS * TS)
                if (row_id || pos[j] < 0)
                    C[(long long)i * M + j] = (i == j) ? 1.0f : 0.0f;
        }
    }
    const int tiles = (M + TS - 1) / TS;
    const int i0 = (blockIdx.x / tiles) * TS, j0 = (blockIdx.x % tiles) * TS;
    if (i0 >= n || j0 >= n) return;
    const int i = i0 + ty, j = j0 + tx;
    float acc = 0.0f, cmp = 0.0f;
    const int k_first = MODE == kGram ? (max(i0, j0) / TS) * TS : 0;
    for (int k0 = k_first; k0 < n; k0 += TS) {
        // loads clamped into range and unconditional, then masked
        const int ic = min(i, n - 1), jc = min(j, n - 1);
        const int kx = min(k0 + tx, n - 1), ky = min(k0 + ty, n - 1);
        float a;
        if (MODE == kGram) a = A[(long long)ky * n + min(i0 + tx, n - 1)];
        else if (MODE == kResidual) a = S[(long long)idx[ic] * M + idx[kx]];
        else a = A[(long long)ic * n + kx];
        const float b = B[(long long)ky * n + jc];
        if (MODE == kGram)               // A(i, k) = W[k][i]
            As[ty][tx] = (k0 + ty < n && i0 + tx < n) ? a : 0.0f;
        else
            As[tx][ty] = (i < n && k0 + tx < n) ? a : 0.0f;
        Bs[ty][tx] = (k0 + ty < n && j < n) ? b : 0.0f;
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < TS; ++kk) {
            if (MODE == kResidual) dot2(acc, cmp, As[kk][ty], Bs[kk][tx]);
            else acc = __fmaf_rn(As[kk][ty], Bs[kk][tx], acc);
        }
        __syncthreads();
    }
    if (i >= n || j >= n) return;
    const long long o = (long long)i * n + j;
    if (MODE == kGram) {
        C[o] = acc;
    } else if (MODE == kResidual) {
        C[o] = __fsub_rn(__fsub_rn(i == j ? 1.0f : 0.0f, acc), cmp);
    } else {
        C[(long long)idx[i] * M + idx[j]] = __fadd_rn(A[o], acc);
    }
}

// The memset and the six launches, over B streams (BATCHED) or one.
template <bool BATCHED>
int launch_sinv(const float* S, float* out, float* L, float* Dinv, float* W,
                float* X, float* R, float* Y, int* idx, int* pos, int* info,
                int M, int B, long long fs, cudaStream_t st) {
    // the first call raises the dynamic shared memory limits; later calls
    // (possibly inside a CUDA graph capture) only launch
    static int optin = 0;
    int err = spd::raise_smem_limits((const void*)sinv_factor<BATCHED>,
                                     (const void*)sinv_solve<BATCHED>,
                                     SOLVE_SMEM_MAX, &optin);
    if (err) return err;
    // the identity-row flags go to pos, which the factor then overwrites:
    // one memset over the B streams' flags
    if ((err = (int)cudaMemsetAsync(pos, 0, (size_t)B * M * sizeof(int),
                                    st)))
        return err;
    sinv_flags<BATCHED><<<dim3((M + FLAG_ROWS - 1) / FLAG_ROWS, B),
                          FLAG_ROWS * 32, 0, st>>>(S, pos, M);
    if ((err = ekf_last_error())) return err;
    const size_t fsmem = spd::factor_smem_bytes(M, optin);
    sinv_factor<BATCHED><<<dim3(1, B), spd::FACTOR_THREADS, fsmem, st>>>(
        S, L, Dinv, idx, pos, info, M, (int)fsmem, fs);
    if ((err = ekf_last_error())) return err;

    const size_t ysmem = (size_t)M * SLAB * sizeof(float);
    const int in_smem = ysmem <= (size_t)SOLVE_SMEM_MAX;
    sinv_solve<BATCHED><<<dim3((M + SLAB - 1) / SLAB, B), SOLVE_THREADS,
                          in_smem ? ysmem : 0, st>>>(L, Dinv, info, W, Y,
                                                     in_smem, fs);
    if ((err = ekf_last_error())) return err;

    const int tiles = (M + TS - 1) / TS;
    const dim3 grid(tiles * tiles, B);
    sinv_product<kGram, BATCHED><<<grid, TS * TS, 0, st>>>(
        S, W, W, X, idx, pos, info, M, fs);
    if ((err = ekf_last_error())) return err;
    sinv_product<kResidual, BATCHED><<<grid, TS * TS, 0, st>>>(
        S, nullptr, X, R, idx, pos, info, M, fs);
    if ((err = ekf_last_error())) return err;
    sinv_product<kRefine, BATCHED><<<grid, TS * TS, 0, st>>>(
        S, X, R, out, idx, pos, info, M, fs);
    return ekf_last_error();
}

}  // namespace

// out = S^-1 for B streams' S stacked, (B, M, M) each.  Scratch (caller-
// owned): B blocks of fs floats, each a stream's L tri(M) floats, Dinv
// ceil(M / 32) * 32 * 32 floats, W, X and R M x M floats each and Y
// (ceil(M / 8) x M x 8 floats, used only when a slab does not fit
// SOLVE_SMEM_MAX), in that order; idx and pos B x M ints each; info B x 2
// ints, each stream's Mu and non-positive pivots.  B = 1 launches the
// single-stream kernels (fs unused).  Returns the first failing launch's
// cudaError_t, or 0.
EKF_EXPORT int ekf_sinv_batched(const float* S, float* out, float* L,
                                float* Dinv, float* W, float* X, float* R,
                                float* Y, int* idx, int* pos, int* info,
                                int M, int B, long long fs, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (M < 1 || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    if (B > 1)
        return launch_sinv<true>(S, out, L, Dinv, W, X, R, Y, idx, pos, info,
                                 M, B, fs, st);
    return launch_sinv<false>(S, out, L, Dinv, W, X, R, Y, idx, pos, info, M,
                              1, 0, st);
}

// One stream.
EKF_EXPORT int ekf_sinv(const float* S, float* out, float* L, float* Dinv,
                        float* W, float* X, float* R, float* Y, int* idx,
                        int* pos, int* info, int M, void* stream) {
    return ekf_sinv_batched(S, out, L, Dinv, W, X, R, Y, idx, pos, info, M,
                            1, 0, stream);
}
