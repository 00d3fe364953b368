// The SPD solve X = S^-1 B by blocked Cholesky, as two ordinary launches
// on one stream with no host synchronisation and no grid barrier.
//
// Replaces the TPU kernel _cholsolve_kernel / chol_solve_pallas
// (openekfmonoslam_tpu/ops/cholsolve.py:102,151): X = S^-1 B for a dense
// SPD S (M, M) and B (M, K), float32, any M, K >= 1 (the TPU wrapper padded
// M to 64 and K to 128; here the last blocks are ragged).  The TPU kernel
// factors by blocks of 64 and solves through the diagonal blocks'
// inverses; so does this one, on the compacted, factored SPD core of the
// update and the S-inverse (spd_core.cuh), with every row used (the
// contract is a dense S, so there is no flag pass):
//
//   (a) cholsolve_factor  one CTA: S = L L^T by the core's blocked
//                         right-looking Cholesky, panels of NB = 32, with
//                         the TPU kernel's pivot clamp (the CLAMP option:
//                         max(pivot, 1e-30) under the square root); L
//                         packed, and T_b = L_bb^-1 of each diagonal
//                         block, to device memory
//   (b) cholsolve_solve   column slabs of B across CTAs, SLAB = 8 columns
//                         a CTA, each held in shared memory (rows padded
//                         to a multiple of NB with zeros): Y = L^-1 B_s by
//                         spd::forward_solve, then X_s = L^-T Y by
//                         spd::backward_solve, both by block rows through
//                         the T_b, with L's chunks staged in shared memory;
//                         X written once.  Slabs are independent: no grid
//                         barrier.
//
// The sums: the factor's are the core's (every product a true fp32 FMA
// chain, no TF32); a solve's row update sums a block row's 32 terms in
// four partial sums, T_b's product one sum in order, as in the update's
// and the S-inverse's forward solves (spd_core.cuh schedules each step's
// loads before its stores, and a thread's outputs together).
//
// Bound on the H100: operations.  S, B and X are moved once, 4 (M^2 +
// 2 M K) bytes, and the function needs M^3 / 3 + 2 M^2 K operations: at
// (M, K) = (192, 640) 49.5 MFLOP (0.74 us at 67 TFLOP/s), at (336, 1024)
// 3.64 us.  The design is latency bound: (a) runs ceil(M / 32) panels of
// four block barriers on one SM (L stays in shared memory while its packed
// triangle fits beside the staged panel, M <= about 300 on the H100, and
// works in the device buffer beyond); (b) runs 2 ceil(M / 32) block rows
// in each of ceil(K / 8) CTAs, each reading all of L from L2.
//
// EKF_MARK are the stage marks of tools/small_kernel_clocks.py (no code
// otherwise).

#include "spd_core.cuh"

namespace {

using spd::NB;

constexpr int SLAB = 8;                  // columns of B a solve CTA takes
constexpr int SOLVE_THREADS = 256;
constexpr int SOLVE_SMEM_MAX = 96 * 1024;

// meta: [0] M (every row is used), [1] non-positive pivots; L packed
// tri(M) floats; Dinv ceil(M / NB) NB x NB floats; idx M ints
__global__ void __launch_bounds__(spd::FACTOR_THREADS)
cholsolve_factor(const float* __restrict__ S, float* L,
                 float* __restrict__ Dinv, int* __restrict__ idx,
                 int* __restrict__ meta, int M, int smem_bytes) {
    extern __shared__ float4 smem4[];
    spd::compact_and_factor<true>((float*)smem4, smem_bytes,
                                  [](int) { return true; }, M, S, 0.0f, L,
                                  Dinv, idx, nullptr, meta);
}

// One CTA a slab of SLAB columns c0.. of B: X_s = L^-T L^-1 B_s.  The slab
// (Mp = ceil(M / NB) NB rows) is in shared memory, or at this CTA's part of
// Yglobal when in_smem is 0.
__global__ void __launch_bounds__(SOLVE_THREADS)
cholsolve_solve(const float* __restrict__ B, const float* __restrict__ L,
                const float* __restrict__ Dinv, float* __restrict__ X,
                float* __restrict__ Yglobal, int M, int K, int in_smem) {
    extern __shared__ float smem[];
    __shared__ spd::SolveSmem sm;
    const int tid = threadIdx.x;
    const int c0 = blockIdx.x * SLAB;
    const int Mp = (M + NB - 1) / NB * NB;
    float* Y = in_smem ? smem : Yglobal + (long long)blockIdx.x * Mp * SLAB;
    // slots 8.. (the factor's marks take 0..4 of the same warps)
    EKF_MARK(8, 0.0f);
#pragma unroll 8
    for (int e = tid; e < Mp * SLAB; e += SOLVE_THREADS) {
        const int k = e / SLAB, w = e % SLAB;
        Y[e] = (k < M && c0 + w < K) ? B[(long long)k * K + c0 + w] : 0.0f;
    }
    __syncthreads();
    EKF_MARK(9, Y[tid % (Mp * SLAB)]);
    spd::forward_solve<SLAB, SOLVE_THREADS>(Y, M, 0, L, Dinv, sm);
    EKF_MARK(10, Y[tid % (Mp * SLAB)]);
    spd::backward_solve<SLAB, SOLVE_THREADS>(Y, M, L, Dinv, sm);
    EKF_MARK(11, Y[tid % (Mp * SLAB)]);
    for (int e = tid; e < M * SLAB; e += SOLVE_THREADS) {
        const int k = e / SLAB, w = e % SLAB;
        if (c0 + w < K) X[(long long)k * K + c0 + w] = Y[e];
    }
    EKF_MARK(12, 0.0f);
}

}  // namespace

// X (M, K) = S^-1 B.  Scratch (caller-owned): L tri(M) floats, Dinv
// ceil(M / 32) * 32 * 32 floats, Y (ceil(K / 8) x ceil(M / 32) 32 x 8
// floats, used only when a slab does not fit SOLVE_SMEM_MAX), idx M ints,
// meta 2 ints (M and the non-positive pivots).  Returns the first failing
// launch's cudaError_t, or 0.
EKF_EXPORT int ekf_cholsolve(const float* S, const float* B, float* X,
                             float* L, float* Dinv, float* Y, int* idx,
                             int* meta, int M, int K, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    if (M < 1 || K < 1) return (int)cudaErrorInvalidValue;
    // the first call raises the dynamic shared memory limits; later calls
    // (possibly inside a CUDA graph capture) only launch
    static int optin = 0;
    int err = spd::raise_smem_limits((const void*)cholsolve_factor,
                                     (const void*)cholsolve_solve,
                                     SOLVE_SMEM_MAX, &optin);
    if (err) return err;
    const size_t fsmem = spd::factor_smem_bytes(M, optin);
    cholsolve_factor<<<1, spd::FACTOR_THREADS, fsmem, st>>>(
        S, L, Dinv, idx, meta, M, (int)fsmem);
    if ((err = ekf_last_error())) return err;
    const int Mp = (M + NB - 1) / NB * NB;
    const size_t ysmem = (size_t)Mp * SLAB * sizeof(float);
    const int in_smem = ysmem <= (size_t)SOLVE_SMEM_MAX;
    cholsolve_solve<<<(K + SLAB - 1) / SLAB, SOLVE_THREADS,
                      in_smem ? ysmem : 0, st>>>(B, L, Dinv, X, Y, M, K,
                                                 in_smem);
    return ekf_last_error();
}
