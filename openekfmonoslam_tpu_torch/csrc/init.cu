// New-landmark initialization chain: for every candidate pixel, the
// inverse-depth feature (anchor = camera position, bearing angles theta,
// phi, rho0) and its hand-derived Jacobians J1 = d(feat)/d(r, q) (6x7)
// and J2 = d(feat)/d(u, v, rho) (6x3).
//
// Replaces the TPU kernel _init_kernel / init_chain_pallas
// (openekfmonoslam_tpu/ops/init_kernel.py:48,138).  The chain is
// undistort (one-shot polynomial) -> back-project -> rotate by R(q) ->
// theta = atan2(gx, gz), phi = atan2(-gy, |(gx, gz)|), with the closed-form
// gradients of each step.  Mosaic had no atan2, so the TPU caller took the
// angles outside its kernel; CUDA has atan2f, so they are computed here.
// The plain version (ops/init_kernel.py init_plain) is the vmapped
// forward-mode Jacobian of filter/features.py init_feature.
//
// Bound on the H100: launch latency.  C = 96 candidates read 2 floats and
// write 6 + 42 + 18 floats each (~26 KB), ~200 flops each.  Design: one
// thread per candidate, writing the full padded (C, 6, 7) / (C, 6, 3)
// blocks the covariance einsums of filter/features.py consume.

#include "common.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
init_kernel(const float* __restrict__ cam7, const float* __restrict__ cand_uv,
            float* __restrict__ feats, float* __restrict__ J1,
            float* __restrict__ J2, int C, float rho0, CamParams c) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= C) return;
    const float qw = cam7[3], qx = cam7[4], qy = cam7[5], qz = cam7[6];
    const float u = cand_uv[2 * i], v = cand_uv[2 * i + 1];

    // one-shot undistort and its (u, v) Jacobian
    const float du = u - c.cx, dv = v - c.cy;
    const float mx = c.dx * du, my = c.dy * dv;
    const float r2 = mx * mx + my * my;
    const float d = 1.0f + c.k1 * r2 + c.k2 * r2 * r2;
    const float g2 = 2.0f * (c.k1 + 2.0f * c.k2 * r2);
    const float a = du * d / c.fx, b = dv * d / c.fy;   // unit-depth ray
    const float da_du = (d + du * g2 * mx * c.dx) / c.fx;
    const float da_dv = (du * g2 * my * c.dy) / c.fx;
    const float db_du = (dv * g2 * mx * c.dx) / c.fy;
    const float db_dv = (d + dv * g2 * my * c.dy) / c.fy;

    // world ray g = R(q) (a, b, 1)
    const float w2 = qw * qw, x2 = qx * qx, y2 = qy * qy, z2 = qz * qz;
    const float R[3][3] = {
        {w2 + x2 - y2 - z2, 2 * (qx * qy - qw * qz), 2 * (qz * qx + qw * qy)},
        {2 * (qx * qy + qw * qz), w2 - x2 + y2 - z2, 2 * (qy * qz - qw * qx)},
        {2 * (qz * qx - qw * qy), 2 * (qy * qz + qw * qx), w2 - x2 - y2 + z2}};
    const float gx = R[0][0] * a + R[0][1] * b + R[0][2];
    const float gy = R[1][0] * a + R[1][1] * b + R[1][2];
    const float gz = R[2][0] * a + R[2][1] * b + R[2][2];

    // d(R(q) v)/dq_k for v = (a, b, 1)
    const float dg[4][3] = {
        {2 * (qw * a - qz * b + qy), 2 * (qz * a + qw * b - qx),
         2 * (-qy * a + qx * b + qw)},
        {2 * (qx * a + qy * b + qz), 2 * (qy * a - qx * b - qw),
         2 * (qz * a + qw * b - qx)},
        {2 * (-qy * a + qx * b + qw), 2 * (qx * a + qy * b + qz),
         2 * (-qw * a + qz * b - qy)},
        {2 * (-qz * a - qw * b + qx), 2 * (qw * a - qz * b + qy),
         2 * (qx * a + qy * b + qz)}};

    // bearing angles and their gradients w.r.t. the world ray
    const float hxz2 = gx * gx + gz * gz;
    const float h = sqrtf(hxz2);
    const float dth_dgx = gz / hxz2, dth_dgz = -gx / hxz2;
    const float den = gy * gy + hxz2;
    const float dph_dgy = -h / den;
    const float dph_dh = gy / den;
    const float dph_dgx = dph_dh * gx / h, dph_dgz = dph_dh * gz / h;

    float* fo = feats + 6 * (size_t)i;
    fo[0] = cam7[0];
    fo[1] = cam7[1];
    fo[2] = cam7[2];
    fo[3] = atan2f(gx, gz);
    fo[4] = atan2f(-gy, h);
    fo[5] = rho0;

    float* j1 = J1 + 42 * (size_t)i;    // (6, 7) row-major
    for (int e = 0; e < 42; ++e) j1[e] = 0.0f;
    j1[0 * 7 + 0] = 1.0f;
    j1[1 * 7 + 1] = 1.0f;
    j1[2 * 7 + 2] = 1.0f;
    for (int k = 0; k < 4; ++k) {
        j1[3 * 7 + 3 + k] = dth_dgx * dg[k][0] + dth_dgz * dg[k][2];
        j1[4 * 7 + 3 + k] =
            dph_dgx * dg[k][0] + dph_dgy * dg[k][1] + dph_dgz * dg[k][2];
    }

    // d(theta, phi)/d(u, v) through the ray
    const float dgx_du = R[0][0] * da_du + R[0][1] * db_du;
    const float dgx_dv = R[0][0] * da_dv + R[0][1] * db_dv;
    const float dgy_du = R[1][0] * da_du + R[1][1] * db_du;
    const float dgy_dv = R[1][0] * da_dv + R[1][1] * db_dv;
    const float dgz_du = R[2][0] * da_du + R[2][1] * db_du;
    const float dgz_dv = R[2][0] * da_dv + R[2][1] * db_dv;
    float* j2 = J2 + 18 * (size_t)i;    // (6, 3) row-major
    for (int e = 0; e < 18; ++e) j2[e] = 0.0f;
    j2[3 * 3 + 0] = dth_dgx * dgx_du + dth_dgz * dgz_du;
    j2[3 * 3 + 1] = dth_dgx * dgx_dv + dth_dgz * dgz_dv;
    j2[4 * 3 + 0] = dph_dgx * dgx_du + dph_dgy * dgy_du + dph_dgz * dgz_du;
    j2[4 * 3 + 1] = dph_dgx * dgx_dv + dph_dgy * dgy_dv + dph_dgz * dgz_dv;
    j2[5 * 3 + 2] = 1.0f;
}

}  // namespace

EKF_EXPORT int ekf_init(const float* cam7, const float* cand_uv, float* feats,
                        float* J1, float* J2, int C, float rho0,
                        const CamParams* cam, void* stream) {
    const int blocks = (C + THREADS - 1) / THREADS;
    init_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        cam7, cand_uv, feats, J1, J2, C, rho0, *cam);
    return ekf_last_error();
}
