// The joint EKF update over a masked set of matches, with the post-update
// numerics, as four launches on one stream (no host synchronisation):
//
//   (a) update_sinv     one block: S = Sfull o (u u^T) + diag(r), r =
//                       pixel_error on used rows and 1 elsewhere, inverted
//                       in place by Gauss-Jordan elimination -> Sinv (M, M);
//                       the steps of unused rows are identities and skipped
//   (b) update_gain     tiled GEMM: W = Sinv (HP o u)            (M, N)
//   (c) update_downdate tiled dual GEMM: P' = 1/2 (P + P^T) - 1/2 (D + D^T),
//                       D = (HP o u)^T W, both products accumulated in
//                       one tile loop (the symmetrize step folded in; P'
//                       is exactly symmetric)
//   (d) update_finalize one block: dx = W^T res, x' = x + dx, then the
//                       quaternion renormalization of x' and its Jacobian
//                       Jq through P' rows and columns 3:7
//
// with u the per-row use mask (M = 2F rows, row m belongs to slot m/2).
// Everything is gated by applied = any(use), read on the device: with no
// slot used, x and P come back bit-identical.
//
// Replaces the TPU kernel _update_kernel / joint_update_pallas
// (openekfmonoslam_tpu/ops/update_kernel.py:73,158) and the Newton-Schulz
// inverse it embeds (ns_inverse_into, ops/sinv.py:68).  The TPU's 3-pass
// bf16 products are not ported: every product here is a true fp32 FMA
// chain.  The inverse is Gauss-Jordan rather than Newton-Schulz: S is SPD
// with lambda_min >= min(pixel_error, 1), so elimination without pivoting
// is stable, it costs M^3 multiply-adds (Newton-Schulz: ~28 M^3 for its 14
// iterations), and its cost does not depend on cond(S).
//
// Bound on the H100: fp32 operations.  With Mu used rows the update needs
// 2 Mu^3 (the inverse) + 2 Mu^2 N (W) + 2 Mu N^2 (D, once: D^T is the
// same numbers) + 2 Mu N (dx); at N = 640 with all M = 192 rows used that
// is ~0.22 GFLOP, ~3.3 us at 67 TFLOP/s, and the traffic is ~3.9 MB
// (~1.2 us).  (c) computes D and D^T as two products, twice the downdate's
// need, to keep P' exactly symmetric.  (a) runs on one SM and is latency
// bound by its Mu block-wide barrier steps; (b) and (c) use 64x64 tiles
// with 4x4 register micro-tiles.  (d) needs its own launch: it reads P'
// rows 3:7 that (c) writes from every block.
//
// No shape cap: S lives in shared memory when M^2 + 2M floats fit the
// block's opt-in limit (M <= 237 on the H100) and in the Sinv buffer in
// device memory otherwise.

#include "common.cuh"

namespace {

constexpr int SINV_TX = 32, SINV_TY = 32;
constexpr int BM = 64, BN = 64, BK = 16, GEMM_THREADS = 256;
constexpr int FIN_THREADS = 1024;

__device__ __forceinline__ bool row_used(const uint8_t* use, int m) {
    return use[m >> 1] != 0;
}

__global__ void __launch_bounds__(SINV_TX * SINV_TY)
update_sinv(const float* __restrict__ Sfull, const uint8_t* __restrict__ use,
            float* __restrict__ Sinv, int M, float pixel_error, int in_smem) {
    extern __shared__ float smem[];
    float* colk = smem;          // column k before the step
    float* rowk = smem + M;      // row k after scaling by the pivot
    float* A = in_smem ? smem + 2 * M : Sinv;
    const int tx = threadIdx.x, ty = threadIdx.y;

    for (int i = ty; i < M; i += SINV_TY) {
        const bool ui = row_used(use, i);
        for (int j = tx; j < M; j += SINV_TX) {
            float v = (ui && row_used(use, j)) ? Sfull[(size_t)i * M + j]
                                               : 0.0f;
            if (i == j) v += ui ? pixel_error : 1.0f;
            A[(size_t)i * M + j] = v;
        }
    }
    __syncthreads();

    const int tid = ty * SINV_TX + tx;
    for (int k = 0; k < M; ++k) {
        // an unused row k is e_k in S and stays e_k through every step,
        // so its own step is the identity: skip it (block-uniform)
        if (!row_used(use, k)) continue;
        const float piv = 1.0f / A[(size_t)k * M + k];
        for (int i = tid; i < M; i += SINV_TX * SINV_TY) {
            colk[i] = A[(size_t)i * M + k];
            rowk[i] = A[(size_t)k * M + i] * piv;
        }
        __syncthreads();
        for (int i = ty; i < M; i += SINV_TY) {
            const float ci = colk[i];
            for (int j = tx; j < M; j += SINV_TX) {
                float v;
                if (i == k) v = (j == k) ? piv : rowk[j];
                else if (j == k) v = -ci * piv;
                else v = A[(size_t)i * M + j] - ci * rowk[j];
                A[(size_t)i * M + j] = v;
            }
        }
        __syncthreads();
    }
    if (in_smem) {
        for (int i = ty; i < M; i += SINV_TY)
            for (int j = tx; j < M; j += SINV_TX)
                Sinv[(size_t)i * M + j] = A[(size_t)i * M + j];
    }
}

// W (M, N) = Sinv (M, M) @ (HP o u) (M, N)
__global__ void __launch_bounds__(GEMM_THREADS)
update_gain(const float* __restrict__ Sinv, const float* __restrict__ HP,
            const uint8_t* __restrict__ use, float* __restrict__ W, int M,
            int N) {
    __shared__ float As[BK][BM];
    __shared__ float Bs[BK][BN];
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    float acc[4][4] = {};
    for (int k0 = 0; k0 < M; k0 += BK) {
        for (int e = threadIdx.x; e < BM * BK; e += GEMM_THREADS) {
            const int mm = e / BK, kk = e % BK;
            const int m = m0 + mm, k = k0 + kk;
            As[kk][mm] = (m < M && k < M) ? Sinv[(size_t)m * M + k] : 0.0f;
        }
        for (int e = threadIdx.x; e < BK * BN; e += GEMM_THREADS) {
            const int kk = e / BN, nn = e % BN;
            const int k = k0 + kk, n = n0 + nn;
            Bs[kk][nn] = (k < M && n < N && row_used(use, k))
                             ? HP[(size_t)k * N + n] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                a[t] = As[kk][ty * 4 + t];
                b[t] = Bs[kk][tx * 4 + t];
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int s = 0; s < 4; ++s) acc[r][s] += a[r] * b[s];
        }
        __syncthreads();
    }
    for (int r = 0; r < 4; ++r) {
        const int m = m0 + ty * 4 + r;
        if (m >= M) continue;
        for (int s = 0; s < 4; ++s) {
            const int n = n0 + tx * 4 + s;
            if (n < N) W[(size_t)m * N + n] = acc[r][s];
        }
    }
}

// P' (N, N) = P - 1/2 ((HP o u)^T W + W^T (HP o u)), or P when unused
__global__ void __launch_bounds__(GEMM_THREADS)
update_downdate(const float* __restrict__ P, const float* __restrict__ HP,
                const float* __restrict__ W, const uint8_t* __restrict__ use,
                float* __restrict__ P_out, int M, int N, int F) {
    __shared__ float A1[BK][BM];   // (HP o u)[k, i-tile]
    __shared__ float B1[BK][BN];   // W[k, j-tile]
    __shared__ float A2[BK][BM];   // W[k, i-tile]
    __shared__ float B2[BK][BN];   // (HP o u)[k, j-tile]
    int any = 0;
    for (int f = threadIdx.x; f < F; f += GEMM_THREADS) any |= use[f];
    const bool applied = __syncthreads_or(any) != 0;

    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
    // D and D^T in separate sums: acc2 at (i, j) runs the same products in
    // the same order as acc1 at (j, i), so P' comes out exactly symmetric
    float acc1[4][4] = {}, acc2[4][4] = {};
    if (applied) {
        for (int k0 = 0; k0 < M; k0 += BK) {
            for (int e = threadIdx.x; e < BK * BM; e += GEMM_THREADS) {
                const int kk = e / BM, ii = e % BM;
                const int k = k0 + kk;
                const bool kin = k < M;
                const bool ku = kin && row_used(use, k);
                const int i = i0 + ii, j = j0 + ii;
                A1[kk][ii] = (ku && i < N) ? HP[(size_t)k * N + i] : 0.0f;
                A2[kk][ii] = (kin && i < N) ? W[(size_t)k * N + i] : 0.0f;
                B1[kk][ii] = (kin && j < N) ? W[(size_t)k * N + j] : 0.0f;
                B2[kk][ii] = (ku && j < N) ? HP[(size_t)k * N + j] : 0.0f;
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < BK; ++kk) {
                float a1[4], a2[4], b1[4], b2[4];
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    a1[t] = A1[kk][ty * 4 + t];
                    a2[t] = A2[kk][ty * 4 + t];
                    b1[t] = B1[kk][tx * 4 + t];
                    b2[t] = B2[kk][tx * 4 + t];
                }
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int s = 0; s < 4; ++s) {
                        acc1[r][s] += a1[r] * b1[s];
                        acc2[r][s] += a2[r] * b2[s];
                    }
            }
            __syncthreads();
        }
    }
    // applied: P' = 1/2 (P + P^T) - 1/2 (D + D^T), the plain chain's
    // downdate followed by its symmetrize step
    for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        if (i >= N) continue;
        for (int s = 0; s < 4; ++s) {
            const int j = j0 + tx * 4 + s;
            if (j >= N) continue;
            const size_t o = (size_t)i * N + j;
            P_out[o] = applied
                ? 0.5f * (P[o] + P[(size_t)j * N + i])
                      - 0.5f * (acc1[r][s] + acc2[r][s])
                : P[o];
        }
    }
}

__global__ void __launch_bounds__(FIN_THREADS)
update_finalize(const float* __restrict__ x, const float* __restrict__ W,
                const float* __restrict__ uv, const float* __restrict__ z,
                const uint8_t* __restrict__ use, float* __restrict__ x_out,
                float* __restrict__ P_out, int N, int F) {
    __shared__ float sq[4];
    __shared__ float sJ[4][4];
    __shared__ float sC[4][4];
    __shared__ float s_inv_n;
    const int tid = threadIdx.x;
    const int M = 2 * F;
    int any = 0;
    for (int f = tid; f < F; f += FIN_THREADS) any |= use[f];
    const bool applied = __syncthreads_or(any) != 0;

    // dx = W^T res with res = (z - uv) o u; x' = x + dx when applied
    for (int n = tid; n < N; n += FIN_THREADS) {
        float xn = x[n];
        if (applied) {
            float dx = 0.0f;
            for (int m = 0; m < M; ++m)
                if (row_used(use, m)) dx += W[(size_t)m * N + n] * (z[m] - uv[m]);
            xn += dx;
        }
        x_out[n] = xn;
        if (n >= 3 && n < 7) sq[n - 3] = xn;
    }
    if (!applied) return;   // block-uniform
    __syncthreads();

    if (tid == 0) {
        const float w = sq[0], qx = sq[1], qy = sq[2], qz = sq[3];
        const float n2 = w * w + qx * qx + qy * qy + qz * qz;
        const float inv_n = rsqrtf(n2);
        const float a = inv_n * inv_n * inv_n;
        const float J[4][4] = {
            {qx * qx + qy * qy + qz * qz, -w * qx, -w * qy, -w * qz},
            {-qx * w, w * w + qy * qy + qz * qz, -qx * qy, -qx * qz},
            {-qy * w, -qy * qx, w * w + qx * qx + qz * qz, -qy * qz},
            {-qz * w, -qz * qx, -qz * qy, w * w + qx * qx + qy * qy}};
        for (int r = 0; r < 4; ++r)
            for (int s = 0; s < 4; ++s) sJ[r][s] = a * J[r][s];
        s_inv_n = inv_n;
    }
    if (tid < 16) sC[tid / 4][tid % 4] = P_out[(size_t)(3 + tid / 4) * N + 3 + tid % 4];
    __syncthreads();

    if (tid < 4) x_out[3 + tid] = sq[tid] * s_inv_n;
    // thread t owns column t of rows 3:7 and row t of columns 3:7; the
    // 4x4 corner (t in 3:7) is J C J^T from the copy taken above, averaged
    // with its transpose so that P' stays exactly symmetric (the strips
    // below are symmetric by construction)
    for (int t = tid; t < N; t += FIN_THREADS) {
        if (t >= 3 && t < 7) {
            const int b = t - 3;
            for (int a = 0; a < 4; ++a) {
                float v_ab = 0.0f, v_ba = 0.0f;
                for (int l = 0; l < 4; ++l) {
                    float cb = 0.0f, ca = 0.0f;
                    for (int n = 0; n < 4; ++n) {
                        cb += sC[l][n] * sJ[b][n];
                        ca += sC[l][n] * sJ[a][n];
                    }
                    v_ab += sJ[a][l] * cb;
                    v_ba += sJ[b][l] * ca;
                }
                P_out[(size_t)(3 + a) * N + t] = 0.5f * (v_ab + v_ba);
            }
        } else {
            float col[4], row[4];
            for (int l = 0; l < 4; ++l) {
                col[l] = P_out[(size_t)(3 + l) * N + t];
                row[l] = P_out[(size_t)t * N + 3 + l];
            }
            for (int a = 0; a < 4; ++a) {
                float vc = 0.0f, vr = 0.0f;
                for (int l = 0; l < 4; ++l) {
                    vc += sJ[a][l] * col[l];
                    vr += row[l] * sJ[a][l];
                }
                P_out[(size_t)(3 + a) * N + t] = vc;
                P_out[(size_t)t * N + 3 + a] = vr;
            }
        }
    }
}

}  // namespace

// Sinv (M, M) and W (M, N) are caller-owned scratch, M = 2F.  Returns the
// first failing launch's cudaError_t, or 0.
EKF_EXPORT int ekf_update(const float* P, const float* x, const float* HP,
                          const float* Sfull, const float* uv, const float* z,
                          const uint8_t* use, float* P_out, float* x_out,
                          float* Sinv, float* W, int N, int F,
                          float pixel_error, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int M = 2 * F;
    // the first call raises update_sinv's dynamic shared memory limit to
    // the device's opt-in maximum; later calls (possibly inside a CUDA
    // graph capture) only launch
    static int optin = 0;
    int err = 0;
    if (optin == 0) {
        int device = 0, value = 0;
        if ((err = (int)cudaGetDevice(&device))) return err;
        if ((err = (int)cudaDeviceGetAttribute(
                 &value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)))
            return err;
        if ((err = (int)cudaFuncSetAttribute(
                 update_sinv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                 value)))
            return err;
        optin = value;
    }
    const size_t small = 2 * (size_t)M * sizeof(float);
    const size_t full = small + (size_t)M * M * sizeof(float);
    const int in_smem = full <= (size_t)optin;
    const size_t smem = in_smem ? full : small;

    update_sinv<<<1, dim3(SINV_TX, SINV_TY), smem, st>>>(
        Sfull, use, Sinv, M, pixel_error, in_smem);
    if ((err = ekf_last_error())) return err;

    dim3 g_gain((N + BN - 1) / BN, (M + BM - 1) / BM);
    update_gain<<<g_gain, GEMM_THREADS, 0, st>>>(Sinv, HP, use, W, M, N);
    if ((err = ekf_last_error())) return err;

    dim3 g_down((N + BN - 1) / BN, (N + BM - 1) / BM);
    update_downdate<<<g_down, GEMM_THREADS, 0, st>>>(P, HP, W, use, P_out,
                                                     M, N, F);
    if ((err = ekf_last_error())) return err;

    update_finalize<<<1, FIN_THREADS, 0, st>>>(x, W, uv, z, use, x_out,
                                               P_out, N, F);
    return ekf_last_error();
}
