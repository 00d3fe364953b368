// EKF predict phase: constant-velocity motion model, analytic F, process
// noise Qc = G diag(q) G^T, and the covariance strips, in one launch.
//
// Replaces the TPU kernel _predict_kernel / predict_pallas
// (openekfmonoslam_tpu/ops/predict_kernel.py:48,154).  Same math as the
// plain version (ops/predict_kernel.py predict_plain):
//   x'[0:13] = f(x[0:13]);   P'[0:13, j] = F P[0:13, j];
//   P'[i, 0:13] = P[i, 0:13] F^T;   P'[0:13, 0:13] = F P00 F^T + Qc;
//   P'[13:, 13:] = P[13:, 13:] (bit-exact pass-through).
// Output is out of place: the TPU kernel rewrites rows 0:13 in place and
// then reads them back for the column update; here blocks run in parallel,
// so every element of P' is computed from the ORIGINAL P.
//
// Bound on the H100: bytes.  The out-of-place P' is 2 N^2 floats of
// traffic (3.3 MB at N = 640, ~1 us at 3.35 TB/s); the strips are 26 N
// multiply-adds.  At N = 640 the launch latency dominates.  Design: a grid
// of 128-column x 16-row tiles, one thread per column (coalesced rows);
// each block rebuilds the 13x13 F and Qc in shared memory (scalar work),
// stages the strip inputs it reads in shared memory or registers, and the
// corner tile forms P00 F^T once, so no thread runs a long serial chain.

#include "common.cuh"

namespace {

constexpr int C13 = 13;
constexpr int TILE_COLS = 128;
constexpr int TILE_ROWS = 16;     // >= 13: the corner lies in one tile

__global__ void __launch_bounds__(TILE_COLS)
predict_kernel(const float* __restrict__ P, const float* __restrict__ x,
               float* __restrict__ P_out, float* __restrict__ x_out, int N,
               float dt, float lin, float ang) {
    __shared__ float sF[C13][C13];
    __shared__ float sQ[C13][C13];
    __shared__ float sDq[4][3];     // dq'/dw
    __shared__ float sRr[4][4];     // dq'/dq: right-multiplication by q2
    __shared__ float sX[C13];       // propagated camera state

    const int tid = threadIdx.x;
    if (tid == 0) {
        const float qw = x[3], qx = x[4], qy = x[5], qz = x[6];
        const float u0 = x[10] * dt, u1 = x[11] * dt, u2 = x[12] * dt;
        const float n2 = u0 * u0 + u1 * u1 + u2 * u2;
        const float n = sqrtf(n2);
        const float half = 0.5f * n;
        const float c = cosf(half);
        const bool small = n < 1e-6f;
        // s = sin(n/2)/n and g = (cos(n/2)/2 - s)/n^2, exact small-n limits
        const float s = small ? 0.5f - n2 / 48.0f : sinf(half) / n;
        const float g = small ? -1.0f / 24.0f + n2 / 960.0f
                              : (0.5f * c - s) / n2;
        const float aw = c, ax = s * u0, ay = s * u1, az = s * u2;
        const float u[3] = {u0, u1, u2};
        float dq2[4][3];
        for (int j = 0; j < 3; ++j) {
            dq2[0][j] = -0.5f * s * u[j];
            for (int i = 0; i < 3; ++i)
                dq2[1 + i][j] = (i == j ? s : 0.0f) + g * u[i] * u[j];
        }
        const float L[4][4] = {{qw, -qx, -qy, -qz}, {qx, qw, -qz, qy},
                               {qy, qz, qw, -qx}, {qz, -qy, qx, qw}};
        for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 3; ++j) {
                float acc = 0.0f;
                for (int k = 0; k < 4; ++k) acc += L[i][k] * dq2[k][j];
                sDq[i][j] = acc * dt;
            }
        const float Rr[4][4] = {{aw, -ax, -ay, -az}, {ax, aw, az, -ay},
                                {ay, -az, aw, ax}, {az, ay, -ax, aw}};
        for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 4; ++j) sRr[i][j] = Rr[i][j];
        sX[0] = x[0] + x[7] * dt;
        sX[1] = x[1] + x[8] * dt;
        sX[2] = x[2] + x[9] * dt;
        sX[3] = qw * aw - qx * ax - qy * ay - qz * az;
        sX[4] = qw * ax + qx * aw + qy * az - qz * ay;
        sX[5] = qw * ay - qx * az + qy * aw + qz * ax;
        sX[6] = qw * az + qx * ay - qy * ax + qz * aw;
        for (int i = 7; i < C13; ++i) sX[i] = x[i];
    }
    __syncthreads();

    // F and Qc, one entry per thread (169 entries)
    for (int e = tid; e < C13 * C13; e += blockDim.x) {
        const int i = e / C13, j = e % C13;
        float f = (i == j) ? 1.0f : 0.0f;
        if (i < 3 && j == i + 7) f = dt;
        if (i >= 3 && i < 7 && j >= 3 && j < 7) f = sRr[i - 3][j - 3];
        if (i >= 3 && i < 7 && j >= 10) f = sDq[i - 3][j - 10];
        sF[i][j] = f;

        float q = 0.0f;
        if (i == j && i < 3) q += lin * dt * dt;
        if ((i < 3 && j == i + 7) || (j < 3 && i == j + 7)) q += lin * dt;
        if (i == j && i >= 7 && i < 10) q += lin;
        if (i == j && i >= 10) q += ang;
        if (i >= 3 && i < 7 && j >= 3 && j < 7) {
            float acc = 0.0f;
            for (int k = 0; k < 3; ++k) acc += sDq[i - 3][k] * sDq[j - 3][k];
            q += ang * acc;
        }
        if (i >= 3 && i < 7 && j >= 10) q += ang * sDq[i - 3][j - 10];
        if (j >= 3 && j < 7 && i >= 10) q += ang * sDq[j - 3][i - 10];
        sQ[i][j] = q;
    }
    __syncthreads();

    // stage what the strips read: the left strip's P[i0:i_end, 0:13] (the
    // first column tile only) and, in the corner tile, T = P00 F^T
    __shared__ float sPc[TILE_ROWS][C13];
    __shared__ float sT[C13][C13];
    const int i0 = blockIdx.y * TILE_ROWS, j0 = blockIdx.x * TILE_COLS;
    const int i_end = min(N, i0 + TILE_ROWS);
    if (j0 == 0) {                                   // block-uniform
        for (int e = tid; e < TILE_ROWS * C13; e += blockDim.x) {
            const int r = e / C13, l = e % C13;
            sPc[r][l] = (i0 + r < N) ? P[(size_t)(i0 + r) * N + l] : 0.0f;
        }
        __syncthreads();
        if (i0 == 0) {
            for (int e = tid; e < C13 * C13; e += blockDim.x) {
                const int k = e / C13, c = e % C13;
                float t = 0.0f;
                for (int l = 0; l < C13; ++l) t += sPc[k][l] * sF[c][l];
                sT[k][c] = t;
            }
            __syncthreads();
        }
    }

    const int j = j0 + tid;
    if (j >= N) return;
    if (blockIdx.y == 0) x_out[j] = (j < C13) ? sX[j] : x[j];
    // the top strip's inputs: this column's P[0:13, j]
    float pcol[C13];
    if (i0 < C13 && j >= C13) {
#pragma unroll
        for (int k = 0; k < C13; ++k) pcol[k] = P[(size_t)k * N + j];
    }

#pragma unroll
    for (int r = 0; r < TILE_ROWS; ++r) {
        const int i = i0 + r;
        if (i >= i_end) break;
        const size_t o = (size_t)i * N + j;
        float v;
        if (i < C13 && j < C13) {
            // F P00 F^T + Qc from the original corner, averaged with its
            // transpose so that the corner stays exactly symmetric (the
            // strips are symmetric by construction when P is)
            float v_ij = 0.0f, v_ji = 0.0f;
            for (int k = 0; k < C13; ++k) {
                v_ij += sF[i][k] * sT[k][j];
                v_ji += sF[j][k] * sT[k][i];
            }
            v = sQ[i][j] + 0.5f * (v_ij + v_ji);
        } else if (i < C13) {
            v = 0.0f;
#pragma unroll
            for (int k = 0; k < C13; ++k) v += sF[i][k] * pcol[k];
        } else if (j < C13) {
            v = 0.0f;
            for (int l = 0; l < C13; ++l) v += sPc[r][l] * sF[j][l];
        } else {
            v = P[o];
        }
        P_out[o] = v;
    }
}

}  // namespace

EKF_EXPORT int ekf_predict(const float* P, const float* x, float* P_out,
                           float* x_out, int N, float dt, float lin,
                           float ang, void* stream) {
    dim3 grid((N + TILE_COLS - 1) / TILE_COLS,
              (N + TILE_ROWS - 1) / TILE_ROWS);
    predict_kernel<<<grid, TILE_COLS, 0, (cudaStream_t)stream>>>(
        P, x, P_out, x_out, N, dt, lin, ang);
    return ekf_last_error();
}
