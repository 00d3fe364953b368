// EKF predict phase: constant-velocity motion model, analytic F, process
// noise Qc = G diag(q) G^T, and the covariance strips, in one launch.
//
// Replaces the TPU kernel _predict_kernel / predict_pallas
// (openekfmonoslam_tpu/ops/predict_kernel.py:48,154).  Same math as the
// plain version (ops/predict_kernel.py predict_plain):
//   x'[0:13] = f(x[0:13]);   P'[0:13, j] = F P[0:13, j];
//   P'[i, 0:13] = P[i, 0:13] F^T;   P'[0:13, 0:13] = F P00 F^T + Qc;
//   P'[13:, 13:] = P[13:, 13:] (bit-exact pass-through).
// Output is out of place: the JAX step donates nothing, so a caller's old
// state stays valid, and every element of P' is computed from the
// ORIGINAL P.
//
// Bound on the H100: bytes.  The out-of-place P' is 2 N^2 floats of
// traffic (3.3 MB at N = 640, ~1 us at 3.35 TB/s); the strips are 26 N
// multiply-adds.  Design: the grid is split by role, and no element is
// written by two blocks.
//   - Copy blocks own P[13:, c0:], where c0 is 16 when every row starts
//     16-byte aligned (N % 4 == 0 and aligned bases), else 13.  They run
//     no prologue, use no shared memory and no barrier: each thread moves
//     64 bytes (four 16-byte vectors, or sixteen floats on the scalar
//     fallback), all loads in flight before the first store.
//   - Block 0 owns the corner P'[0:13, 0:13] and x'[0:13].  It alone
//     builds Qc and T = P00 F^T, after F.
//   - Top strip blocks own P'[0:13, 13:] and x'[13:], two threads a
//     column (rows 0:7 and 7:13; the first copies x[j]); left strip
//     blocks own P'[13:, 0:c0], two threads a row (columns 0:8 and 8:16,
//     two 16-byte stores each, passing columns 13:c0 through).
//   Every non-copy block issues its loads first; then each of its first
//   169 threads computes the motion model's scalars and one entry of F
//   (no serial thread-0 section), and one barrier publishes F, whose rows
//   the strips and the corner read as 16-byte vectors.  At most 85
//   registers a thread keep three blocks on an SM, so that the large
//   map's 266 blocks run in one wave.
// Every sum runs k = 0..12 in order, one multiply-add a term, so the
// outputs do not depend on which block or thread computes them.  EKF_MARK /
// EKF_NOTE are the stage marks of tools/small_kernel_clocks.py (no code
// otherwise).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int C13 = 13;
constexpr int THREADS = 256;
constexpr int COPY_BYTES = 64;     // per copy thread, all in flight
constexpr int LINE_THREADS = 2;    // strip threads a column or row

// The motion model's scalars for the rotation increment quat(w dt), with
// the exact small-angle limits: s = sin(n/2)/n, g = (cos(n/2)/2 - s)/n^2.
struct Motion {
    float qw, qx, qy, qz, u0, u1, u2, c, s, g;
};

__device__ __forceinline__ Motion motion_scalars(const float* __restrict__ x,
                                                 float dt) {
    Motion m;
    m.qw = x[3];
    m.qx = x[4];
    m.qy = x[5];
    m.qz = x[6];
    m.u0 = x[10] * dt;
    m.u1 = x[11] * dt;
    m.u2 = x[12] * dt;
    const float n2 = m.u0 * m.u0 + m.u1 * m.u1 + m.u2 * m.u2;
    const float n = sqrtf(n2);
    const float half = 0.5f * n;
    float sh;
    sincosf(half, &sh, &m.c);
    const bool small = n < 1e-6f;
    m.s = small ? 0.5f - n2 / 48.0f : sh / n;
    m.g = small ? -1.0f / 24.0f + n2 / 960.0f : (0.5f * m.c - m.s) / n2;
    return m;
}

__device__ __forceinline__ float pick3(int i, float a, float b, float c) {
    return i == 0 ? a : (i == 1 ? b : c);
}

__device__ __forceinline__ float pick4(int i, float a, float b, float c,
                                       float d) {
    return i == 0 ? a : (i == 1 ? b : (i == 2 ? c : d));
}

// dq'/dw [a][b] = (L(q) dq2/d(w dt))[a][b] dt, where L(q) is left
// multiplication by q and dq2[0][b] = -s u_b / 2, dq2[1+i][b] =
// [i == b] s + g u_i u_b.
__device__ __forceinline__ float dq_dw(const Motion& m, int a, int b,
                                       float dt) {
    const float l0 = pick4(a, m.qw, m.qx, m.qy, m.qz);
    const float l1 = pick4(a, -m.qx, m.qw, m.qz, -m.qy);
    const float l2 = pick4(a, -m.qy, -m.qz, m.qw, m.qx);
    const float l3 = pick4(a, -m.qz, m.qy, -m.qx, m.qw);
    const float ub = pick3(b, m.u0, m.u1, m.u2);
    const float d0 = -0.5f * m.s * ub;
    const float d1 = (b == 0 ? m.s : 0.0f) + m.g * m.u0 * ub;
    const float d2 = (b == 1 ? m.s : 0.0f) + m.g * m.u1 * ub;
    const float d3 = (b == 2 ? m.s : 0.0f) + m.g * m.u2 * ub;
    float acc = 0.0f;
    acc += l0 * d0;
    acc += l1 * d1;
    acc += l2 * d2;
    acc += l3 * d3;
    return acc * dt;
}

// dq'/dq [a][b]: right multiplication by quat(w dt) = (c, s u), as
// selects (a warp's lanes hold different entries)
__device__ __forceinline__ float dq_dq(const Motion& m, int a, int b) {
    const float aw = m.c, ax = m.s * m.u0, ay = m.s * m.u1, az = m.s * m.u2;
    return pick4(b, pick4(a, aw, ax, ay, az), pick4(a, -ax, aw, -az, ay),
                 pick4(a, -ay, az, aw, -ax), pick4(a, -az, -ay, ax, aw));
}

// x'[j] of the camera state (j < 13), from x[0:13] in shared memory.  The
// quaternion q (x) quat(w dt) is written out in explicit multiply-adds:
// left to the compiler, their contraction follows the code around them,
// and x' would change in its last bits with an unrelated edit.
__device__ __forceinline__ float motion_state(const Motion& m,
                                              const float* x, int j,
                                              float dt) {
    const float aw = m.c, ax = m.s * m.u0, ay = m.s * m.u1, az = m.s * m.u2;
    const float qw = m.qw, qx = m.qx, qy = m.qy, qz = m.qz;
    switch (j) {
        case 0: return x[0] + x[7] * dt;
        case 1: return x[1] + x[8] * dt;
        case 2: return x[2] + x[9] * dt;
        case 3:   // qw aw - qx ax - qy ay - qz az
            return __fmaf_rn(-qz, az, __fmaf_rn(-qy, ay, __fmaf_rn(
                qw, aw, -__fmul_rn(qx, ax))));
        case 4:   // qw ax + qx aw + qy az - qz ay
            return __fmaf_rn(-qz, ay, __fmaf_rn(qy, az, __fmaf_rn(
                qx, aw, __fmul_rn(qw, ax))));
        case 5:   // qw ay - qx az + qy aw + qz ax
            return __fmaf_rn(qz, ax, __fmaf_rn(qy, aw, __fmaf_rn(
                qw, ay, -__fmul_rn(qx, az))));
        case 6:   // qw az + qx ay - qy ax + qz aw
            return __fmaf_rn(qz, aw, __fmaf_rn(-qy, ax, __fmaf_rn(
                qw, az, __fmul_rn(qx, ay))));
        default: return x[j];
    }
}

// F[i][j] of the 13-dim camera state
__device__ __forceinline__ float motion_f(const Motion& m, int i, int j,
                                          float dt) {
    float f = (i == j) ? 1.0f : 0.0f;
    if (i < 3 && j == i + 7) f = dt;
    if (i >= 3 && i < 7 && j >= 3 && j < 7) f = dq_dq(m, i - 3, j - 3);
    if (i >= 3 && i < 7 && j >= 10) f = dq_dw(m, i - 3, j - 10, dt);
    return f;
}

// Qc[i][j] = G diag(q) G^T, with dq'/dw read from F[3:7, 10:13]
__device__ __forceinline__ float motion_q(const float (*sF)[16], int i,
                                          int j, float dt, float lin,
                                          float ang) {
    float q = 0.0f;
    if (i == j && i < 3) q += lin * dt * dt;
    if ((i < 3 && j == i + 7) || (j < 3 && i == j + 7)) q += lin * dt;
    if (i == j && i >= 7 && i < 10) q += lin;
    if (i == j && i >= 10) q += ang;
    if (i >= 3 && i < 7 && j >= 3 && j < 7) {
        float acc = 0.0f;
        for (int k = 0; k < 3; ++k) acc += sF[i][10 + k] * sF[j][10 + k];
        q += ang * acc;
    }
    if (i >= 3 && i < 7 && j >= 10) q += ang * sF[i][j];
    if (j >= 3 && j < 7 && i >= 10) q += ang * sF[j][i];
    return q;
}

// 16 floats of a 16-byte aligned row of shared memory, as 4 vectors
__device__ __forceinline__ void row16(const float* __restrict__ row,
                                      float* out) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(row)[q];
        out[4 * q] = v.x;
        out[4 * q + 1] = v.y;
        out[4 * q + 2] = v.z;
        out[4 * q + 3] = v.w;
    }
}

// sum_k u[k] v[k], k = 0..12 in order, one multiply-add a term
__device__ __forceinline__ float dot13(const float* u, const float* v) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < C13; ++k) acc += u[k] * v[k];
    return acc;
}

// sum_k F[r][k] a[k] with F's row r in shared memory
__device__ __forceinline__ float row_dot(const float* __restrict__ Frow,
                                         const float* a) {
    float f[16];
    row16(Frow, f);
    return dot13(f, a);
}

#ifdef EKF_STAGE_CLOCKS
__device__ __forceinline__ float first(float v) { return v; }
__device__ __forceinline__ float first(float4 v) { return v.x; }
#endif

struct Layout {
    int N, c0;            // first column of the copy region
    int n_top, n_left;    // strip blocks after block 0: top, left
    unsigned copy_w;      // vectors per row of the copy region
    unsigned copy_v;      // vectors in the copy region
};

template <int VEC>
__global__ void __launch_bounds__(THREADS, 3)
predict_kernel(const float* __restrict__ P, const float* __restrict__ x,
               float* __restrict__ P_out, float* __restrict__ x_out,
               Layout L, float dt, float lin, float ang) {
    constexpr int K = COPY_BYTES / (4 * VEC);
    using Vec = typename std::conditional<VEC == 4, float4, float>::type;
    const int N = L.N;
    const int tid = threadIdx.x;
    const int b = blockIdx.x;
    EKF_MARK(0, 0.0f);

    if (b > L.n_top + L.n_left) {
        // ---- copy block: P'[13:, c0:] = P[13:, c0:]
        const unsigned v0 =
            (unsigned)(b - 1 - L.n_top - L.n_left) * THREADS * K + tid;
        Vec buf[K];
        size_t off[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const unsigned v = v0 + k * THREADS;
            off[k] = 0;
            if (v < L.copy_v) {
                const unsigned r = v / L.copy_w;
                off[k] = ((size_t)(C13 + r) * N + L.c0) / VEC
                         + (v - r * L.copy_w);
                buf[k] = reinterpret_cast<const Vec*>(P)[off[k]];
            }
        }
        EKF_MARK(3, first(buf[K - 1]));
#pragma unroll
        for (int k = 0; k < K; ++k)
            if (v0 + k * THREADS < L.copy_v)
                reinterpret_cast<Vec*>(P_out)[off[k]] = buf[k];
        EKF_MARK(4, 0.0f);
        return;
    }

    // 13 x 16 tiles: rows 16-byte aligned, read as vectors
    __shared__ __align__(16) float sF[C13][16];
    __shared__ __align__(16) float sP00[C13][16];
    __shared__ __align__(16) float sTt[C13][16];   // (P00 F^T)^T
    __shared__ float sQ[C13][C13];
    __shared__ float sX[C13];
    const int role = b == 0 ? 0 : (b <= L.n_top ? 1 : 2);  // corner, top,
    const int t = (role == 1 ? b - 1 : b - 1 - L.n_top) * THREADS + tid;
    const int g = t % LINE_THREADS;                            // left
    const int line = C13 + t / LINE_THREADS;  // top: column; left: row
    const bool mine = role == 0 ? tid < C13 * C13 : line < N;

    // the inputs first, so that their latency overlaps the prologue: the
    // corner's P00 and x[0:13], a top column P[0:13, j] and x[j], a left
    // row P[i, 0:c0]
    float a[16];
    if (role == 0) {
        if (mine) sP00[tid / C13][tid % C13] = P[(size_t)(tid / C13) * N
                                                 + tid % C13];
        if (tid < C13) sX[tid] = x[tid];
    } else if (mine) {
        if (role == 1) {
#pragma unroll
            for (int k = 0; k < C13; ++k) a[k] = P[(size_t)k * N + line];
            if (g == 0) x_out[line] = x[line];
        } else if (VEC == 4) {
            row16(P + (size_t)line * N, a);
        } else {
#pragma unroll
            for (int k = 0; k < C13; ++k) a[k] = P[(size_t)line * N + k];
        }
    }

    Motion m;
    if (tid < C13 * C13) {
        m = motion_scalars(x, dt);
        EKF_MARK(1, m.s + m.g + m.c);
        sF[tid / C13][tid % C13] = motion_f(m, tid / C13, tid % C13, dt);
    }
    __syncthreads();
    EKF_MARK(2, 0.0f);

    if (role == 0) {
        // x'[0:13]; Qc and T = P00 F^T; then the corner F P00 F^T + Qc
        // averaged with its transpose, so that it stays exactly symmetric
        // (the strips are symmetric by construction when P is)
        const int r = tid / C13, j = tid % C13;
        float u[16], v[16];
        if (tid < C13) x_out[tid] = motion_state(m, sX, tid, dt);
        if (mine) {
            sQ[r][j] = motion_q(sF, r, j, dt, lin, ang);
            row16(sP00[r], u);
            row16(sF[j], v);
            sTt[j][r] = dot13(u, v);
        }
        __syncthreads();
        EKF_MARK(3, 0.0f);
        if (!mine) return;
        float w[16];
        row16(sF[r], u);
        row16(sTt[j], v);
        const float v_rj = dot13(u, v);
        row16(sF[j], u);
        row16(sTt[r], w);
        const float v_jr = dot13(u, w);
        P_out[(size_t)r * N + j] = sQ[r][j] + 0.5f * (v_rj + v_jr);
        EKF_MARK(4, 0.0f);
        return;
    }
    EKF_MARK(3, mine ? a[C13 - 1] : 0.0f);
    if (!mine) return;

    if (role == 1) {
        // rows R g : R (g + 1) of column `line`
        constexpr int R = (C13 + LINE_THREADS - 1) / LINE_THREADS;
#pragma unroll
        for (int q = 0; q < R; ++q) {
            const int r = R * g + q;
            const float v = row_dot(sF[min(r, C13 - 1)], a);
            if (r < C13) P_out[(size_t)r * N + line] = v;
        }
    } else {
        // columns W g : W (g + 1) of row `line`, columns 13:c0 passed
        // through
        constexpr int W = 16 / LINE_THREADS;
        float out[W];
#pragma unroll
        for (int q = 0; q < W; ++q) {
            const int col = W * g + q;
            const float v = row_dot(sF[min(col, C13 - 1)], a);
            out[q] = col < C13 ? v
                               : (col == 13 ? a[13] : (col == 14 ? a[14]
                                                                 : a[15]));
        }
        float* row = P_out + (size_t)line * N + W * g;
        if (VEC == 4) {
#pragma unroll
            for (int q = 0; q < W / 4; ++q)
                reinterpret_cast<float4*>(row)[q] = make_float4(
                    out[4 * q], out[4 * q + 1], out[4 * q + 2],
                    out[4 * q + 3]);
        } else {
#pragma unroll
            for (int q = 0; q < W; ++q)
                if (W * g + q < C13) row[q] = out[q];
        }
    }
    EKF_MARK(4, 0.0f);
}

}  // namespace

EKF_EXPORT int ekf_predict(const float* P, const float* x, float* P_out,
                           float* x_out, int N, float dt, float lin,
                           float ang, void* stream) {
    if (N < C13 || N > 46340)       // the copy's 32-bit vector index
        return (int)cudaErrorInvalidValue;
    // 16-byte vectors when every row of P and P' starts 16-byte aligned
    const bool vec = N % 4 == 0 && N >= 16
                     && ((uintptr_t)P | (uintptr_t)P_out) % 16 == 0;
    const int per_vec = vec ? 4 : 1;
    Layout L;
    L.N = N;
    L.c0 = vec ? 16 : C13;
    L.n_top = (LINE_THREADS * (N - C13) + THREADS - 1) / THREADS;
    L.n_left = L.n_top;
    L.copy_w = (unsigned)(N - L.c0) / per_vec;
    L.copy_v = (unsigned)(N - C13) * L.copy_w;
    const unsigned per_block = THREADS * COPY_BYTES / (4 * per_vec);
    const int n_copy = (int)((L.copy_v + per_block - 1) / per_block);
    const int blocks = 1 + L.n_top + L.n_left + n_copy;
    if (vec)
        predict_kernel<4><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            P, x, P_out, x_out, L, dt, lin, ang);
    else
        predict_kernel<1><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            P, x, P_out, x_out, L, dt, lin, ang);
    return ekf_last_error();
}
