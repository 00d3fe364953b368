// The joint EKF update over a masked set of matches, with the post-update
// numerics, in factored form: three launches on one stream, no host
// synchronisation, capturable in a CUDA graph.
//
// With u the per-row use mask (M = 2F rows, row m belongs to slot m / 2),
// idx the Mu used rows, S_u = Sfull[idx, idx] + pixel_error I and
// res_u = (z - uv)[idx]:
//
//   (a) update_factor    one CTA: compact the used rows (spd_core.cuh),
//                        S_u = L L^T by the blocked Cholesky
//   (b) update_solve     column slabs of [HP_u | res_u] across CTAs:
//                        V = L^-1 HP_u and y = L^-1 res_u by blocked
//                        forward substitution with the diagonal blocks'
//                        inverses; dx = V^T y (= K res) for the slab's
//                        columns, x' = x + dx; the CTA of columns 3:7
//                        renormalizes q and writes its Jacobian Jq
//   (c) update_downdate  P' = 1/2 (P + P^T) - V^T V (= P - 1/2 (D + D^T),
//                        D = HP^T S^-1 HP) over the upper-triangle tiles
//                        only, each writing P'(I, J) and P'(J, I) from the
//                        same numbers, so P' is exactly symmetric; the
//                        tiles of rows 3:7 then push Jq through P' rows
//                        and columns 3:7 in their epilogue (the strips
//                        Jq P'[3:7, J], the corner 1/2 (Jq C Jq^T + its
//                        transpose))
//
// Everything is gated by applied = any(use) = (Mu > 0), read on the
// device: with no slot used, x and P come back bit-identical.
//
// Replaces the TPU kernel _update_kernel / joint_update_pallas
// (openekfmonoslam_tpu/ops/update_kernel.py:73,158) and the Newton-Schulz
// inverse it embeds (ns_inverse_into, ops/sinv.py:68).  S^-1 is never
// formed.  The TPU's 3-pass bf16 products are not ported: every product
// here is a true fp32 FMA chain.
//
// Bound on the H100: fp32 operations.  With Mu used rows the factored
// update needs Mu^3 / 6 (Cholesky) + Mu^2 N / 2 (V) + Mu N^2 / 2 (V^T V
// on one triangle) + Mu N (dx) multiply-adds over P (N, N) read and
// written once; at N = 640 and Mu = 132 that is ~0.07 GFLOP, ~1.0 us at 67
// TFLOP/s.  The work is latency bound: (a) runs on one SM through
// ceil(Mu / 32) panels of sequential steps (spd_core.cuh), (b) through
// ceil(Mu / 32) block rows of three barriers each in every CTA, (c) is one
// tiled pass.
//
// No shape cap.  (a) keeps L in shared memory while its packed triangle
// fits and works on it in device memory (the L buffer) otherwise; (b)
// keeps its slab in shared memory while it fits SOLVE_SMEM_MAX bytes and
// in the caller's per-CTA device-memory scratch otherwise.

#include "spd_core.cuh"

namespace {

using spd::NB;
using spd::tri;

constexpr int SLAB = 16;                 // columns of HP a solve CTA takes
constexpr int SW = SLAB + 1;             // ... plus the residual column
constexpr int SOLVE_THREADS = 256;
constexpr int SOLVE_SMEM_MAX = 96 * 1024;
constexpr int TILE = 64, BK = 16, DD_THREADS = 256;
constexpr int TS = TILE + 1;             // row stride of the staged tile

__device__ __forceinline__ bool slot_used(const uint8_t* use, int m) {
    return use[m >> 1] != 0;
}

// meta: [0] Mu, [1] non-positive pivots; L packed tri(M) floats; Dinv
// ceil(M / NB) NB x NB floats; idx M ints
__global__ void __launch_bounds__(spd::FACTOR_THREADS)
update_factor(const float* __restrict__ Sfull, const uint8_t* __restrict__ use,
              float* L, float* __restrict__ Dinv, int* __restrict__ idx,
              int* __restrict__ meta, int M, float pixel_error,
              int smem_bytes) {
    extern __shared__ float4 smem4[];
    spd::compact_and_factor((float*)smem4, smem_bytes,
                            [&](int r) { return slot_used(use, r); }, M,
                            Sfull, pixel_error, L, Dinv, idx, nullptr, meta);
}

// A batched launch's operands: B streams' inputs and outputs stacked, the
// scratch in B blocks of fs floats (L, Dinv, V, jq, Y at their
// single-stream offsets) and of M + 2 ints (idx, meta).  blockIdx.y is the
// stream; its CTAs run exactly the single-stream work on its own block.
__global__ void __launch_bounds__(spd::FACTOR_THREADS)
update_factor_batched(const float* __restrict__ Sfull,
                      const uint8_t* __restrict__ use, float* L,
                      float* __restrict__ Dinv, int* __restrict__ idx,
                      int* __restrict__ meta, int M, float pixel_error,
                      int smem_bytes, long long fs) {
    extern __shared__ float4 smem4[];
    const long long s = blockIdx.y, si = s * (M + 2);
    const uint8_t* u = use + s * (M / 2);
    spd::compact_and_factor((float*)smem4, smem_bytes,
                            [&](int r) { return slot_used(u, r); }, M,
                            Sfull + s * M * M, pixel_error, L + s * fs,
                            Dinv + s * fs, idx + si, nullptr, meta + si);
}

// One CTA a slab of SLAB columns of HP_u, plus res_u: Y = L^-1 [HP_u | res_u]
// by block rows of NB, V = Y[:, :SLAB], dx = V^T y, x' = x + dx.  The CTA
// of columns 3:7 (the first, SLAB >= 7) renormalizes q and writes Jq.
__device__ __forceinline__ void
update_solve_body(const float* __restrict__ x, const float* __restrict__ HP,
                  const float* __restrict__ uv, const float* __restrict__ z,
                  const float* __restrict__ L, const float* __restrict__ Dinv,
                  const int* __restrict__ idx, const int* __restrict__ meta,
                  float* __restrict__ V, float* __restrict__ x_out,
                  float* __restrict__ jq, float* __restrict__ Yglobal, int N,
                  int in_smem) {
    extern __shared__ float smem[];
    __shared__ float s_dx[SLAB];
    __shared__ spd::SolveSmem sm;
    const int n0 = blockIdx.x * SLAB;
    const int n = meta[0];
    const int tid = threadIdx.x;
    if (n == 0) {
        for (int w = tid; w < SLAB; w += SOLVE_THREADS)
            if (n0 + w < N) x_out[n0 + w] = x[n0 + w];
        return;
    }
    float* Y = in_smem ? smem : Yglobal + (long long)blockIdx.x * n * SW;
    // [HP_u | res_u] for the slab: loads clamped into range and
    // unconditional, four a thread in flight
    for (int e0 = tid; e0 < n * SW; e0 += 4 * SOLVE_THREADS) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int e = min(e0 + u * SOLVE_THREADS, n * SW - 1);
            const int k = e / SW, w = e % SW;
            const long long r = idx[k];
            const float h = HP[r * N + min(n0 + w, N - 1)];
            const float res = z[r] - uv[r];
            v[u] = w == SLAB ? res : (n0 + w < N ? h : 0.0f);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int e = e0 + u * SOLVE_THREADS;
            if (e < n * SW) Y[e] = v[u];
        }
    }
    __syncthreads();
    spd::forward_solve<SW, SOLVE_THREADS>(Y, n, 0, L, Dinv, sm);
    for (int e = tid; e < n * SLAB; e += SOLVE_THREADS) {
        const int k = e / SLAB, w = e % SLAB;
        if (n0 + w < N) V[(long long)k * N + n0 + w] = Y[k * SW + w];
    }
    // dx = V^T y for the slab's columns: one warp a column
    const int warp = tid >> 5, lane = tid & 31;
    for (int w = warp; w < SLAB; w += SOLVE_THREADS / 32) {
        float s = 0.0f;
        for (int k = lane; k < n; k += 32)
            s = fmaf(Y[k * SW + w], Y[k * SW + SLAB], s);
        for (int o = 16; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) s_dx[w] = s;
    }
    __syncthreads();
    const bool quat = n0 <= 3 && 7 <= n0 + SLAB;
    if (tid < SLAB && n0 + tid < N) {
        const int col = n0 + tid;
        const float v = x[col] + s_dx[tid];
        if (!(quat && col >= 3 && col < 7)) x_out[col] = v;
        s_dx[tid] = v;
    }
    if (!quat) return;
    __syncthreads();
    if (tid == 0) {
        const float* q = s_dx + (3 - n0);
        const float w = q[0], qx = q[1], qy = q[2], qz = q[3];
        const float n2 = w * w + qx * qx + qy * qy + qz * qz;
        const float inv_n = rsqrtf(n2);
        const float a = inv_n * inv_n * inv_n;
        const float J[4][4] = {
            {qx * qx + qy * qy + qz * qz, -w * qx, -w * qy, -w * qz},
            {-qx * w, w * w + qy * qy + qz * qz, -qx * qy, -qx * qz},
            {-qy * w, -qy * qx, w * w + qx * qx + qz * qz, -qy * qz},
            {-qz * w, -qz * qx, -qz * qy, w * w + qx * qx + qy * qy}};
        for (int r = 0; r < 4; ++r) {
            x_out[3 + r] = q[r] * inv_n;
            for (int s = 0; s < 4; ++s) jq[r * 4 + s] = a * J[r][s];
        }
    }
}

__global__ void __launch_bounds__(SOLVE_THREADS)
update_solve(const float* __restrict__ x, const float* __restrict__ HP,
             const float* __restrict__ uv, const float* __restrict__ z,
             const float* __restrict__ L, const float* __restrict__ Dinv,
             const int* __restrict__ idx, const int* __restrict__ meta,
             float* __restrict__ V, float* __restrict__ x_out,
             float* __restrict__ jq, float* __restrict__ Yglobal, int N,
             int in_smem) {
    update_solve_body(x, HP, uv, z, L, Dinv, idx, meta, V, x_out, jq,
                      Yglobal, N, in_smem);
}

__global__ void __launch_bounds__(SOLVE_THREADS)
update_solve_batched(const float* __restrict__ x,
                     const float* __restrict__ HP,
                     const float* __restrict__ uv,
                     const float* __restrict__ z,
                     const float* __restrict__ L,
                     const float* __restrict__ Dinv,
                     const int* __restrict__ idx,
                     const int* __restrict__ meta, float* __restrict__ V,
                     float* __restrict__ x_out, float* __restrict__ jq,
                     float* __restrict__ Yglobal, int N, int in_smem, int M,
                     long long fs) {
    const long long s = blockIdx.y, sf = s * fs, si = s * (M + 2);
    update_solve_body(x + s * N, HP + s * M * N, uv + s * M, z + s * M,
                      L + sf, Dinv + sf, idx + si, meta + si, V + sf,
                      x_out + s * N, jq + sf, Yglobal + sf, N, in_smem);
}

// (Jq C Jq^T)[a][b] for the 4 x 4 corner C (row stride TS)
__device__ __forceinline__ float corner(const float* C, const float* J,
                                        int a, int b) {
    float v = 0.0f;
    for (int l = 0; l < 4; ++l) {
        float cb = 0.0f;
        for (int m = 0; m < 4; ++m) cb = fmaf(C[l * TS + m], J[b * 4 + m], cb);
        v = fmaf(J[a * 4 + l], cb, v);
    }
    return v;
}

// The upper-triangle tile (I, J), I <= J, of P' = 1/2 (P + P^T) - V^T V,
// written to (I, J) and, transposed, to (J, I); the tiles of rows 0:64
// apply Jq to rows and columns 3:7.  With Mu = 0, P is copied.
__device__ __forceinline__ void
update_downdate_body(const float* __restrict__ P, const float* __restrict__ V,
                     const float* __restrict__ jq,
                     const int* __restrict__ meta, float* __restrict__ P_out,
                     int N) {
    __shared__ float Va[BK][TILE];
    __shared__ float Vb[BK][TILE];
    __shared__ float sT[TILE][TS];      // P(J, I) staged, then P'(I, J)
    __shared__ float sJ[16];
    const int J = spd::tri_row(blockIdx.x);
    const int I = blockIdx.x - (int)tri(J);     // I <= J
    const int i0 = I * TILE, j0 = J * TILE;
    const int n = meta[0];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const bool diag = I == J;

    // P(J, I) in shared memory, transposed: sT[ii][jj] = P(j0 + jj, i0 + ii)
    for (int e = tid; e < TILE * TILE; e += DD_THREADS) {
        const int jj = e / TILE, ii = e % TILE;
        const int i = i0 + ii, j = j0 + jj;
        sT[ii][jj] = (i < N && j < N) ? P[(long long)j * N + i] : 0.0f;
    }
    float acc[4][4] = {};
    for (int k0 = 0; k0 < n; k0 += BK) {
        __syncthreads();
        // loads clamped into range and unconditional, all in flight
        float va[BK * TILE / DD_THREADS], vb[BK * TILE / DD_THREADS];
#pragma unroll
        for (int u = 0; u < BK * TILE / DD_THREADS; ++u) {
            const int e = tid + u * DD_THREADS;
            const int k = min(k0 + e / TILE, n - 1), c = e % TILE;
            va[u] = V[(long long)k * N + min(i0 + c, N - 1)];
            vb[u] = V[(long long)k * N + min(j0 + c, N - 1)];
        }
#pragma unroll
        for (int u = 0; u < BK * TILE / DD_THREADS; ++u) {
            const int e = tid + u * DD_THREADS;
            const int kk = e / TILE, c = e % TILE;
            const bool kin = k0 + kk < n;
            Va[kk][c] = kin && i0 + c < N ? va[u] : 0.0f;
            Vb[kk][c] = kin && j0 + c < N ? vb[u] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[4], b[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                a[t] = Va[kk][ty * 4 + t];
                b[t] = Vb[kk][tx * 4 + t];
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int s = 0; s < 4; ++s)
                    acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
        }
    }
    __syncthreads();
    float v[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int ii = ty * 4 + r, i = i0 + ii;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            const int jj = tx * 4 + s, j = j0 + jj;
            const float pij = (i < N && j < N) ? P[(long long)i * N + j] : 0.0f;
            const float pji = sT[ii][jj];
            v[r][s] = n > 0 ? 0.5f * (pij + pji) - acc[r][s] : pij;
            // with Mu = 0 the transposed copy carries P(j, i)
            acc[r][s] = n > 0 ? v[r][s] : pji;
        }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) sT[ty * 4 + r][tx * 4 + s] = acc[r][s];
    if (tid < 16) sJ[tid] = n > 0 ? jq[tid] : 0.0f;
    __syncthreads();

    // rows and columns 3:7 are the quaternion's: the epilogue below writes
    // them (only tiles with I = 0 hold them; with Mu = 0, nothing to push)
    const bool push = n > 0 && I == 0;
    auto is_q = [](int t) { return t >= 3 && t < 7; };
    // P'(I, J), directly: on a diagonal tile only ii <= jj
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int ii = ty * 4 + r, i = i0 + ii;
        if (i >= N) continue;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            const int jj = tx * 4 + s, j = j0 + jj;
            if (j >= N || (diag && ii > jj)) continue;
            if (push && (is_q(i) || is_q(j))) continue;
            P_out[(long long)i * N + j] = v[r][s];
        }
    }
    // P'(J, I) = P'(I, J)^T from shared memory, coalesced along I; on a
    // diagonal tile only the strict lower triangle
    for (int e = tid; e < TILE * TILE; e += DD_THREADS) {
        const int jj = e / TILE, ii = e % TILE;
        const int i = i0 + ii, j = j0 + jj;
        if (i >= N || j >= N || (diag && ii >= jj)) continue;
        if (push && (is_q(i) || is_q(j))) continue;
        P_out[(long long)j * N + i] = sT[ii][jj];
    }
    if (!push) return;
    // the strips: P''(3 + a, t) = P''(t, 3 + a) = sum_l Jq[a][l] P'(3 + l, t)
    for (int e = tid; e < 4 * TILE; e += DD_THREADS) {
        const int a = e / TILE, jj = e % TILE, t = j0 + jj;
        if (t >= N || is_q(t)) continue;
        float s = 0.0f;
        for (int l = 0; l < 4; ++l) s = fmaf(sJ[a * 4 + l], sT[3 + l][jj], s);
        P_out[(long long)(3 + a) * N + t] = s;
        P_out[(long long)t * N + 3 + a] = s;
    }
    // the corner, on tile (0, 0): 1/2 (Jq C Jq^T + its transpose)
    if (diag && tid < 16) {
        const int a = tid / 4, b = tid % 4;
        const float* C = &sT[3][3];
        const float vab = corner(C, sJ, a, b), vba = corner(C, sJ, b, a);
        P_out[(long long)(3 + a) * N + 3 + b] = 0.5f * (vab + vba);
    }
}

__global__ void __launch_bounds__(DD_THREADS)
update_downdate(const float* __restrict__ P, const float* __restrict__ V,
                const float* __restrict__ jq, const int* __restrict__ meta,
                float* __restrict__ P_out, int N) {
    update_downdate_body(P, V, jq, meta, P_out, N);
}

__global__ void __launch_bounds__(DD_THREADS)
update_downdate_batched(const float* __restrict__ P,
                        const float* __restrict__ V,
                        const float* __restrict__ jq,
                        const int* __restrict__ meta,
                        float* __restrict__ P_out, int N, int M,
                        long long fs) {
    const long long s = blockIdx.y, sP = s * N * N;
    update_downdate_body(P + sP, V + s * fs, jq + s * fs, meta + s * (M + 2),
                         P_out + sP, N);
}

}  // namespace

// Scratch (caller-owned): L tri(2F) floats, Dinv ceil(2F / 32) * 32 * 32
// floats, V 2F x N floats, jq 16 floats, Y (ceil(N / 16) x 2F x 17
// floats, used only when a slab does not fit SOLVE_SMEM_MAX), idx 2F ints,
// meta 2 ints (Mu, non-positive pivots).  Returns the first failing
// launch's cudaError_t, or 0.
//
// B streams (B > 1): every operand stacked, the scratch in B blocks of fs
// floats and of 2F + 2 ints, each stream's L ... meta at its blocks' starts
// plus the single-stream offsets; the same three launches with a stream
// axis in their grids.  B = 1 launches the single-stream kernels.
EKF_EXPORT int ekf_update_batched(const float* P, const float* x,
                                  const float* HP, const float* Sfull,
                                  const float* uv, const float* z,
                                  const uint8_t* use, float* P_out,
                                  float* x_out, float* L, float* Dinv,
                                  float* V, float* jq, float* Y, int* idx,
                                  int* meta, int N, int F, int B,
                                  long long fs, float pixel_error,
                                  void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    const int M = 2 * F;
    if (F < 1 || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    if (B > 1) {
        static int optin_b = 0;
        int err = spd::raise_smem_limits((const void*)update_factor_batched,
                                         (const void*)update_solve_batched,
                                         SOLVE_SMEM_MAX, &optin_b);
        if (err) return err;
        const size_t fsmem = spd::factor_smem_bytes(M, optin_b);
        update_factor_batched<<<dim3(1, B), spd::FACTOR_THREADS, fsmem,
                                st>>>(Sfull, use, L, Dinv, idx, meta, M,
                                      pixel_error, (int)fsmem, fs);
        if ((err = ekf_last_error())) return err;
        const size_t ysmem = (size_t)M * SW * sizeof(float);
        const int in_smem = ysmem <= (size_t)SOLVE_SMEM_MAX;
        update_solve_batched<<<dim3((N + SLAB - 1) / SLAB, B), SOLVE_THREADS,
                               in_smem ? ysmem : 0, st>>>(
            x, HP, uv, z, L, Dinv, idx, meta, V, x_out, jq, Y, N, in_smem, M,
            fs);
        if ((err = ekf_last_error())) return err;
        const int tiles = (N + TILE - 1) / TILE;
        update_downdate_batched<<<dim3(tiles * (tiles + 1) / 2, B),
                                  DD_THREADS, 0, st>>>(P, V, jq, meta, P_out,
                                                       N, M, fs);
        return ekf_last_error();
    }
    // the first call raises the factor's and the solve's dynamic shared
    // memory limits; later calls (possibly inside a CUDA graph capture)
    // only launch
    static int optin = 0;
    int err = spd::raise_smem_limits((const void*)update_factor,
                                     (const void*)update_solve,
                                     SOLVE_SMEM_MAX, &optin);
    if (err) return err;
    const size_t fsmem = spd::factor_smem_bytes(M, optin);
    update_factor<<<1, spd::FACTOR_THREADS, fsmem, st>>>(
        Sfull, use, L, Dinv, idx, meta, M, pixel_error, (int)fsmem);
    if ((err = ekf_last_error())) return err;

    const size_t ysmem = (size_t)M * SW * sizeof(float);
    const int in_smem = ysmem <= (size_t)SOLVE_SMEM_MAX;
    update_solve<<<(N + SLAB - 1) / SLAB, SOLVE_THREADS,
                   in_smem ? ysmem : 0, st>>>(
        x, HP, uv, z, L, Dinv, idx, meta, V, x_out, jq, Y, N, in_smem);
    if ((err = ekf_last_error())) return err;

    const int tiles = (N + TILE - 1) / TILE;
    update_downdate<<<tiles * (tiles + 1) / 2, DD_THREADS, 0, st>>>(
        P, V, jq, meta, P_out, N);
    return ekf_last_error();
}

// One stream (tools/small_kernel_clocks.py calls this entry).
EKF_EXPORT int ekf_update(const float* P, const float* x, const float* HP,
                          const float* Sfull, const float* uv, const float* z,
                          const uint8_t* use, float* P_out, float* x_out,
                          float* L, float* Dinv, float* V, float* jq,
                          float* Y, int* idx, int* meta, int N, int F,
                          float pixel_error, void* stream) {
    return ekf_update_batched(P, x, HP, Sfull, uv, z, use, P_out, x_out, L,
                              Dinv, V, jq, Y, idx, meta, N, F, 1, 0,
                              pixel_error, stream);
}
