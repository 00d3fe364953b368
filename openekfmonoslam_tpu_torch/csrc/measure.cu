// Measurement prediction chain: for every feature slot, the predicted
// distorted pixel, the visibility gate and the analytic Jacobians
// Hc7 = dh/d(r, q) (2x7) and Hf = dh/d(feature) (2x6).
//
// Replaces the TPU kernel _kernel / measure_chain_pallas
// (openekfmonoslam_tpu/ops/measure_kernel.py:44,237), correct-math chain
// only (the reference-quirks variants are not ported).  Line for line the
// plain version (filter/measure_fast.py measurements_with_jacobians +
// visibility): rotate the inverse-depth or XYZ point into the camera,
// project, distort by 10 Newton iterations plus the final implicit step,
// then the chain rule IDJ @ FPJ @ d(p_cam)/d(...).
//
// Bound on the H100: launch latency.  F = 96 slots read 6 floats and write
// 2 + 14 + 12 floats and a flag each (~11 KB), and do ~400 flops each.
// Design: one thread per slot, no shared memory; the TPU's 128-lane
// padding and 29-row packing are gone -- outputs are written in the
// (F, 2), (F, 2, 7), (F, 2, 6), (F,) layouts the caller uses.

#include "common.cuh"

namespace {

constexpr int NEWTON_ITERS = 10;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
measure_kernel(const float* __restrict__ cam7, const float* __restrict__ feats,
               const uint8_t* __restrict__ is_xyz,
               const uint8_t* __restrict__ active, float* __restrict__ uv_out,
               float* __restrict__ hc_out, float* __restrict__ hf_out,
               uint8_t* __restrict__ vis_out, int F, CamParams c) {
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    if (f >= F) return;

    const float r0 = cam7[0], r1 = cam7[1], r2 = cam7[2];
    const float w = cam7[3], q1 = cam7[4], q2 = cam7[5], q3 = cam7[6];
    const float w2 = w * w, x2 = q1 * q1, y2 = q2 * q2, z2 = q3 * q3;
    // Rt[i][j] = R(q)[j][i]
    float Rt[3][3];
    Rt[0][0] = w2 + x2 - y2 - z2;
    Rt[1][0] = 2 * (q1 * q2 - w * q3);
    Rt[2][0] = 2 * (q3 * q1 + w * q2);
    Rt[0][1] = 2 * (q1 * q2 + w * q3);
    Rt[1][1] = w2 - x2 + y2 - z2;
    Rt[2][1] = 2 * (q2 * q3 - w * q1);
    Rt[0][2] = 2 * (q3 * q1 - w * q2);
    Rt[1][2] = 2 * (q2 * q3 + w * q1);
    Rt[2][2] = w2 - x2 - y2 + z2;

    const float* fe = feats + 6 * (size_t)f;
    const float theta = fe[3], phi = fe[4], rho = fe[5];
    const float cph = cosf(phi), sph = sinf(phi);
    const float cth = cosf(theta), sth = sinf(theta);
    const float ox = fe[0] - r0, oy = fe[1] - r1, oz = fe[2] - r2;
    const bool xyz = is_xyz[f] != 0;
    // a = XYZ ? (p - r) : rho (p0 - r) + m(theta, phi)
    const float ax = xyz ? ox : rho * ox + cph * sth;
    const float ay = xyz ? oy : rho * oy + (-sph);
    const float az = xyz ? oz : rho * oz + cph * cth;

    const float px = Rt[0][0] * ax + Rt[0][1] * ay + Rt[0][2] * az;
    const float py = Rt[1][0] * ax + Rt[1][1] * ay + Rt[1][2] * az;
    const float pz_raw = Rt[2][0] * ax + Rt[2][1] * ay + Rt[2][2] * az;
    const float pz = fabsf(pz_raw) < 1e-6f ? 1.0f : pz_raw;

    // projection + Newton distortion
    const float inv_z = 1.0f / pz;
    const float uu = c.cx + c.fx * px * inv_z;
    const float vu = c.cy + c.fy * py * inv_z;
    const float du = uu - c.cx, dv = vu - c.cy;
    const float mx = c.dx * du, my = c.dy * dv;
    const float r2m = fmaxf(mx * mx + my * my, 1e-12f);
    const float ru = sqrtf(r2m);
    float rd = ru / (1.0f + c.k1 * r2m + c.k2 * r2m * r2m);
    for (int it = 0; it < NEWTON_ITERS; ++it) {
        const float rd2 = rd * rd;
        const float fv = rd + c.k1 * rd2 * rd + c.k2 * rd2 * rd2 * rd - ru;
        const float fp = 1.0f + 3.0f * c.k1 * rd2 + 5.0f * c.k2 * rd2 * rd2;
        rd = rd - fv / fp;
    }
    // final step: gp = g'(rd) at the pre-step radius feeds the derivative
    const float rds = rd, rd2s = rd * rd;
    const float fvs = rds + c.k1 * rd2s * rds + c.k2 * rd2s * rd2s * rds - ru;
    const float gp = 1.0f + 3.0f * c.k1 * rd2s + 5.0f * c.k2 * rd2s * rd2s;
    rd = rds - fvs / gp;
    const float rd2 = rd * rd;
    const float d = 1.0f + c.k1 * rd2 + c.k2 * rd2 * rd2;
    const float ud = c.cx + du / d, vd = c.cy + dv / d;
    uv_out[2 * f] = ud;
    uv_out[2 * f + 1] = vd;

    // IDJ = d(distort)/d(uv_undist), implicit function theorem
    const float dd_drd = 2.0f * c.k1 * rd + 4.0f * c.k2 * rd * rd2;
    const float cmul = dd_drd / (gp * ru);
    const float inv_d = 1.0f / d, inv_d2 = inv_d * inv_d;
    const float i00 = inv_d - du * cmul * c.dx * c.dx * du * inv_d2;
    const float i01 = -du * cmul * c.dy * c.dy * dv * inv_d2;
    const float i10 = -dv * cmul * c.dx * c.dx * du * inv_d2;
    const float i11 = inv_d - dv * cmul * c.dy * c.dy * dv * inv_d2;
    // FPJ = d(project)/d(p_cam); proj = IDJ @ FPJ (2x3)
    const float f00 = c.fx * inv_z, f02 = -px * c.fx * inv_z * inv_z;
    const float f11 = c.fy * inv_z, f12 = -py * c.fy * inv_z * inv_z;
    const float p00 = i00 * f00, p01 = i01 * f11, p02 = i00 * f02 + i01 * f12;
    const float p10 = i10 * f00, p11 = i11 * f11, p12 = i10 * f02 + i11 * f12;

    float* hc = hc_out + 14 * (size_t)f;   // (2, 7) row-major
    float* hf = hf_out + 12 * (size_t)f;   // (2, 6) row-major
    const float s = xyz ? 1.0f : rho;
    const float inv = xyz ? 0.0f : 1.0f;
    // pR[j] = proj @ (column j of Rt)
    for (int j = 0; j < 3; ++j) {
        const float pr0 = p00 * Rt[0][j] + p01 * Rt[1][j] + p02 * Rt[2][j];
        const float pr1 = p10 * Rt[0][j] + p11 * Rt[1][j] + p12 * Rt[2][j];
        hc[j] = -s * pr0;
        hc[7 + j] = -s * pr1;
        hf[j] = xyz ? pr0 : rho * pr0;
        hf[6 + j] = xyz ? pr1 : rho * pr1;
    }

    // dh/dq through the conjugate quaternion (measure_fast.py)
    const float cw = w, cx_ = -q1, cy_ = -q2, cz_ = -q3;
    const float cq[4][3] = {
        {2 * (cw * ax - cz_ * ay + cy_ * az), 2 * (cz_ * ax + cw * ay - cx_ * az),
         2 * (-cy_ * ax + cx_ * ay + cw * az)},
        {2 * (cx_ * ax + cy_ * ay + cz_ * az), 2 * (cy_ * ax - cx_ * ay - cw * az),
         2 * (cz_ * ax + cw * ay - cx_ * az)},
        {2 * (-cy_ * ax + cx_ * ay + cw * az), 2 * (cx_ * ax + cy_ * ay + cz_ * az),
         2 * (-cw * ax + cz_ * ay - cy_ * az)},
        {2 * (-cz_ * ax - cw * ay + cx_ * az), 2 * (cw * ax - cz_ * ay + cy_ * az),
         2 * (cx_ * ax + cy_ * ay + cz_ * az)}};
    for (int k = 0; k < 4; ++k) {
        const float sg = k == 0 ? 1.0f : -1.0f;
        hc[3 + k] = sg * (p00 * cq[k][0] + p01 * cq[k][1] + p02 * cq[k][2]);
        hc[10 + k] = sg * (p10 * cq[k][0] + p11 * cq[k][1] + p12 * cq[k][2]);
    }

    // Hf bearing and inverse-depth columns: proj @ Rt @ v
    const float vth[3] = {cph * cth, 0.0f, -cph * sth};    // dm/dtheta
    const float vph[3] = {-sph * sth, -cph, -sph * cth};   // dm/dphi
    const float voff[3] = {ox, oy, oz};                     // p0 - r
    const float* vs[3] = {vth, vph, voff};
    for (int col = 0; col < 3; ++col) {
        const float* v = vs[col];
        const float t0 = Rt[0][0] * v[0] + Rt[0][1] * v[1] + Rt[0][2] * v[2];
        const float t1 = Rt[1][0] * v[0] + Rt[1][1] * v[1] + Rt[1][2] * v[2];
        const float t2 = Rt[2][0] * v[0] + Rt[2][1] * v[1] + Rt[2][2] * v[2];
        hf[3 + col] = inv * (p00 * t0 + p01 * t1 + p02 * t2);
        hf[9 + col] = inv * (p10 * t0 + p11 * t1 + p12 * t2);
    }

    // visibility: active, in front and inside the FOV (unclamped p_cam),
    // and inside the image
    const bool fov = (pz_raw > 0.0f) && (fabsf(px) < pz_raw * c.tan_x)
                     && (fabsf(py) < pz_raw * c.tan_y);
    const bool img = (ud > 0.0f) && (ud < c.pixels_x) && (vd > 0.0f)
                     && (vd < c.pixels_y);
    vis_out[f] = (active[f] != 0) && fov && img;
}

}  // namespace

EKF_EXPORT int ekf_measure(const float* cam7, const float* feats,
                           const uint8_t* is_xyz, const uint8_t* active,
                           float* uv, float* hc7, float* hf, uint8_t* visible,
                           int F, const CamParams* cam, void* stream) {
    const int blocks = (F + THREADS - 1) / THREADS;
    measure_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        cam7, feats, is_xyz, active, uv, hc7, hf, visible, F, *cam);
    return ekf_last_error();
}
