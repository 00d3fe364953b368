// Measurement prediction chain: for every feature slot, the predicted
// distorted pixel, the visibility gate and the analytic Jacobians
// Hc = dh/d(camera) (2x13, columns 7:13 zero) and Hf = dh/d(feature)
// (2x6), written masked, as the caller consumes them.
//
// Replaces the TPU kernel _kernel / measure_chain_pallas
// (openekfmonoslam_tpu/ops/measure_kernel.py:44,237), both of its variants,
// chosen as there by a flag that is uniform over the launch (a template
// parameter here, instantiated twice):
//   - the correct-math chain;
//   - QUIRKS, the reference's bug-compatible chain of the parity mode
//     (measure_kernel.py:115-131, 160-166, 193-196): the one-shot
//     undistort Jacobian at the distorted pixel, inverted through its
//     determinant, as IDJ; entry (0, 1) of dh/dr's R^T zeroed (the
//     jacobian[1]/[2] slip, dh/dr only); the world-frame anchor offset in
//     the drho column.  The value h(x) and the gate are the same.
// Line for line the plain version (filter/measure_fast.py
// measurements_with_jacobians + visibility): rotate the inverse-depth or
// XYZ point into the camera, project, distort by 10 Newton iterations plus
// the final implicit step, then the chain rule IDJ @ FPJ @ d(p_cam)/d(...).
// Then the caller's epilogue (openekfmonoslam_tpu/filter/measure.py:
// 151-158): Hc and Hf multiplied by visible (0 or 1, so a non-finite
// value in a masked slot stays non-finite, as in the PyTorch chain), Hf's
// columns 3:6 multiplied by 0 for XYZ slots, uv set to 0 where not visible.
//
// Bound on the H100: launch latency.  F = 96 slots read 6 floats each and
// write 2 + 26 + 12 floats and a flag (~16 KB), ~400 flops each.  The
// time is one thread's dependency chain, so the design shortens it:
//   - sincosf once an angle; R(q)^T once a block, in shared memory;
//   - the Newton loop leaves as soon as every lane of the warp sits on a
//     fixed point or a two-value cycle (the step is a deterministic
//     function of rd, so the result is the full loop's bit for bit), and a
//     zero step skips the divide's slow path;
//   - the outputs are staged in shared memory and written by the whole
//     block in coalesced 16-byte vectors.
// The IEEE divides stay: the bound is 1e-6 relative.  One thread computes
// both rows of a slot's H: a split of the rows over two threads shortens
// the tail, but it changes the compiler's multiply-add contraction and
// with it the correct-math outputs' last bits.  EKF_MARK / EKF_NOTE are the stage marks of
// tools/small_kernel_clocks.py (no code otherwise).

#include "common.cuh"

namespace {

constexpr int NEWTON_ITERS = 10;
constexpr int THREADS = 128;
constexpr int OUT_FLOATS = 2 + 26 + 12;   // uv, Hc, Hf of one slot

// a / b, IEEE.  The divide's hardware check sends a zero dividend to its
// slow path (hundreds of cycles); a zero over a positive finite divisor is
// the dividend itself, so that case is taken apart.  The Newton steps meet
// it at every converged lane.
__device__ __forceinline__ float div_step(float a, float b) {
    if (a == 0.0f && b > 0.0f && isfinite(b)) return a;
    return a / b;
}

// n floats from shared memory to global memory in 16-byte vectors (dst
// and src 16-byte aligned), the tail as floats; all as floats without VEC
// (a batched launch's later streams start off a 16-byte boundary when F
// is odd)
template <bool VEC>
__device__ __forceinline__ void copy_out(float* __restrict__ dst,
                                         const float* __restrict__ src,
                                         int n) {
    const int n4 = VEC ? n / 4 : 0;
    for (int k = threadIdx.x; k < n4; k += blockDim.x)
        reinterpret_cast<float4*>(dst)[k] =
            reinterpret_cast<const float4*>(src)[k];
    for (int k = 4 * n4 + threadIdx.x; k < n; k += blockDim.x)
        dst[k] = src[k];
}

// The kernel's work on one stream (both entry points below run it).
template <bool QUIRKS, bool VEC>
__device__ __forceinline__ void
measure_body(const float* __restrict__ cam7, const float* __restrict__ feats,
             const uint8_t* __restrict__ is_xyz,
             const uint8_t* __restrict__ active, float* __restrict__ uv_out,
             float* __restrict__ hc_out, float* __restrict__ hf_out,
             uint8_t* __restrict__ vis_out, int F, CamParams c) {
    __shared__ float sRt[3][3];
    __shared__ float sR[3];
    // the block's outputs in their global layouts: Hc, Hf, uv
    __shared__ __align__(16) float sOut[THREADS * OUT_FLOATS];
    float* sHc = sOut;
    float* sHf = sOut + THREADS * 26;
    float* sUv = sHf + THREADS * 12;
    EKF_MARK(0, 0.0f);
    // lanes past F compute slot F - 1 and store nothing: every lane of a
    // warp takes part in the Newton loop's vote
    const int f = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = f < F;
    const int fs = live ? f : F - 1;

    if (threadIdx.x == 0) {
        const float w = cam7[3], q1 = cam7[4], q2 = cam7[5], q3 = cam7[6];
        const float w2 = w * w, x2 = q1 * q1, y2 = q2 * q2, z2 = q3 * q3;
        // Rt[i][j] = R(q)[j][i]
        sRt[0][0] = w2 + x2 - y2 - z2;
        sRt[1][0] = 2 * (q1 * q2 - w * q3);
        sRt[2][0] = 2 * (q3 * q1 + w * q2);
        sRt[0][1] = 2 * (q1 * q2 + w * q3);
        sRt[1][1] = w2 - x2 + y2 - z2;
        sRt[2][1] = 2 * (q2 * q3 - w * q1);
        sRt[0][2] = 2 * (q3 * q1 - w * q2);
        sRt[1][2] = 2 * (q2 * q3 + w * q1);
        sRt[2][2] = w2 - x2 - y2 + z2;
        sR[0] = cam7[0];
        sR[1] = cam7[1];
        sR[2] = cam7[2];
    }

    const float* fe = feats + 6 * (size_t)fs;
    const float theta = fe[3], phi = fe[4], rho = fe[5];
    const float f0 = fe[0], f1 = fe[1], f2 = fe[2];
    const bool xyz = is_xyz[fs] != 0;
    const bool act = active[fs] != 0;
    float cph, sph, cth, sth;
    sincosf(phi, &sph, &cph);
    sincosf(theta, &sth, &cth);
    EKF_MARK(1, cph + sph + cth + sth);
    __syncthreads();

    float Rt[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) Rt[i][j] = sRt[i][j];
    const float ox = f0 - sR[0], oy = f1 - sR[1], oz = f2 - sR[2];
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
    // The step is a deterministic function of rd, so once rd repeats the
    // rest of the loop is known: a fixed point (rd' == rd) stays, and a
    // lane that alternates between two values (rd' == the rd before)
    // ends on the one the remaining step count's parity picks.  The warp
    // leaves when every lane is one or the other, with the full loop's
    // result bit for bit.  (Lanes converge in 3 or 4 steps; one in
    // about 30 alternates in the last bit.)
    EKF_NOTE(5, NEWTON_ITERS);
    float prev = __uint_as_float(0xffffffffu);   // no step yields this NaN
    for (int it = 0; it < NEWTON_ITERS; ++it) {
        const float rd2 = rd * rd;
        const float fv = rd + c.k1 * rd2 * rd + c.k2 * rd2 * rd2 * rd - ru;
        const float fp = 1.0f + 3.0f * c.k1 * rd2 + 5.0f * c.k2 * rd2 * rd2;
        const float next = rd - div_step(fv, fp);
        const bool fixed = __float_as_uint(next) == __float_as_uint(rd);
        const bool cycle = __float_as_uint(next) == __float_as_uint(prev);
        prev = rd;
        rd = next;
        if (__all_sync(0xffffffffu, fixed || cycle)) {
            if (!fixed && ((NEWTON_ITERS - it - 1) & 1)) rd = prev;
            EKF_NOTE(5, it + 1);
            break;
        }
    }
    EKF_MARK(2, rd);
    // final step: gp = g'(rd) at the pre-step radius feeds the derivative
    const float rds = rd, rd2s = rd * rd;
    const float fvs = rds + c.k1 * rd2s * rds + c.k2 * rd2s * rd2s * rds - ru;
    const float gp = 1.0f + 3.0f * c.k1 * rd2s + 5.0f * c.k2 * rd2s * rd2s;
    rd = rds - div_step(fvs, gp);
    const float rd2 = rd * rd;
    const float d = 1.0f + c.k1 * rd2 + c.k2 * rd2 * rd2;
    const float ud = c.cx + du / d, vd = c.cy + dv / d;

    float i00, i01, i10, i11;
    if (QUIRKS) {
        // IDJ = inverse of the one-shot undistort Jacobian at the
        // distorted pixel
        const float pdx = ud - c.cx, pdy = vd - c.cy;
        const float mxq = c.dx * pdx, myq = c.dy * pdy;
        const float r2q = mxq * mxq + myq * myq;
        const float radq = 1.0f + c.k1 * r2q + c.k2 * r2q * r2q;
        const float gq = c.k1 + 2.0f * c.k2 * r2q;
        const float u00 = radq + pdx * gq * 2.0f * pdx * c.dx * c.dx;
        const float u01 = pdx * gq * 2.0f * pdy * c.dy * c.dy;
        const float u10 = pdy * gq * 2.0f * pdx * c.dx * c.dx;
        const float u11 = radq + pdy * gq * 2.0f * pdy * c.dy * c.dy;
        const float detq = u00 * u11 - u01 * u10;
        i00 = u11 / detq;
        i01 = -u01 / detq;
        i10 = -u10 / detq;
        i11 = u00 / detq;
    } else {
        // IDJ = d(distort)/d(uv_undist), implicit function theorem
        const float dd_drd = 2.0f * c.k1 * rd + 4.0f * c.k2 * rd * rd2;
        const float cmul = dd_drd / (gp * ru);
        const float inv_d = 1.0f / d, inv_d2 = inv_d * inv_d;
        i00 = inv_d - du * cmul * c.dx * c.dx * du * inv_d2;
        i01 = -du * cmul * c.dy * c.dy * dv * inv_d2;
        i10 = -dv * cmul * c.dx * c.dx * du * inv_d2;
        i11 = inv_d - dv * cmul * c.dy * c.dy * dv * inv_d2;
    }
    // FPJ = d(project)/d(p_cam); proj = IDJ @ FPJ (2x3)
    const float f00 = c.fx * inv_z, f02 = -px * c.fx * inv_z * inv_z;
    const float f11 = c.fy * inv_z, f12 = -py * c.fy * inv_z * inv_z;
    const float p00 = i00 * f00, p01 = i01 * f11, p02 = i00 * f02 + i01 * f12;
    const float p10 = i10 * f00, p11 = i11 * f11, p12 = i10 * f02 + i11 * f12;

    float hc[14];   // (2, 7) row-major: dh/dr, dh/dq
    float hf[12];   // (2, 6) row-major
    const float s = xyz ? 1.0f : rho;
    const float inv = xyz ? 0.0f : 1.0f;
    // pR[j] = proj @ (column j of Rt); dh/dr's column 1 loses Rt[0][1]
    // under QUIRKS (the slip)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const float pr0 = p00 * Rt[0][j] + p01 * Rt[1][j] + p02 * Rt[2][j];
        const float pr1 = p10 * Rt[0][j] + p11 * Rt[1][j] + p12 * Rt[2][j];
        const float rd0 = (QUIRKS && j == 1) ? 0.0f : Rt[0][j];
        const float prd0 = p00 * rd0 + p01 * Rt[1][j] + p02 * Rt[2][j];
        const float prd1 = p10 * rd0 + p11 * Rt[1][j] + p12 * Rt[2][j];
        hc[j] = -s * prd0;
        hc[7 + j] = -s * prd1;
        hf[j] = xyz ? pr0 : rho * pr0;
        hf[6 + j] = xyz ? pr1 : rho * pr1;
    }

    // dh/dq through the conjugate quaternion (measure_fast.py)
    const float cw = cam7[3], cx_ = -cam7[4], cy_ = -cam7[5], cz_ = -cam7[6];
    const float cq[4][3] = {
        {2 * (cw * ax - cz_ * ay + cy_ * az), 2 * (cz_ * ax + cw * ay - cx_ * az),
         2 * (-cy_ * ax + cx_ * ay + cw * az)},
        {2 * (cx_ * ax + cy_ * ay + cz_ * az), 2 * (cy_ * ax - cx_ * ay - cw * az),
         2 * (cz_ * ax + cw * ay - cx_ * az)},
        {2 * (-cy_ * ax + cx_ * ay + cw * az), 2 * (cx_ * ax + cy_ * ay + cz_ * az),
         2 * (-cw * ax + cz_ * ay - cy_ * az)},
        {2 * (-cz_ * ax - cw * ay + cx_ * az), 2 * (cw * ax - cz_ * ay + cy_ * az),
         2 * (cx_ * ax + cy_ * ay + cz_ * az)}};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float sg = k == 0 ? 1.0f : -1.0f;
        hc[3 + k] = sg * (p00 * cq[k][0] + p01 * cq[k][1] + p02 * cq[k][2]);
        hc[10 + k] = sg * (p10 * cq[k][0] + p11 * cq[k][1] + p12 * cq[k][2]);
    }

    // Hf bearing and inverse-depth columns: proj @ Rt @ v; under QUIRKS
    // the drho column is proj @ (p0 - r), unrotated
    const float vth[3] = {cph * cth, 0.0f, -cph * sth};    // dm/dtheta
    const float vph[3] = {-sph * sth, -cph, -sph * cth};   // dm/dphi
    const float voff[3] = {ox, oy, oz};                     // p0 - r
    const float* vs[3] = {vth, vph, voff};
#pragma unroll
    for (int col = 0; col < 3; ++col) {
        const float* v = vs[col];
        const bool rotate = !(QUIRKS && col == 2);
        const float t0 = rotate ? Rt[0][0] * v[0] + Rt[0][1] * v[1]
                                      + Rt[0][2] * v[2] : v[0];
        const float t1 = rotate ? Rt[1][0] * v[0] + Rt[1][1] * v[1]
                                      + Rt[1][2] * v[2] : v[1];
        const float t2 = rotate ? Rt[2][0] * v[0] + Rt[2][1] * v[1]
                                      + Rt[2][2] * v[2] : v[2];
        hf[3 + col] = inv * (p00 * t0 + p01 * t1 + p02 * t2);
        hf[9 + col] = inv * (p10 * t0 + p11 * t1 + p12 * t2);
    }
    // visibility: active, in front and inside the FOV (unclamped p_cam),
    // and inside the image
    const bool fov = (pz_raw > 0.0f) && (fabsf(px) < pz_raw * c.tan_x)
                     && (fabsf(py) < pz_raw * c.tan_y);
    const bool img = (ud > 0.0f) && (ud < c.pixels_x) && (vd > 0.0f)
                     && (vd < c.pixels_y);
    const bool vis = act && fov && img;

    // the masked outputs, staged in shared memory in the global layouts
    // (Hc (F, 2, 13), Hf (F, 2, 6), uv (F, 2)), then written by the whole
    // block in coalesced 16-byte vectors
    const int t = threadIdx.x;
    const float vm = vis ? 1.0f : 0.0f;
#pragma unroll
    for (int e = 0; e < 26; ++e) {
        const int row = e / 13, col = e % 13;
        sHc[26 * t + e] = col < 7 ? hc[7 * row + col] * vm : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 12; ++k) {
        // retired dims of converted-XYZ slots carry no Jacobian
        const float dim = (k % 6 < 3 || !xyz) ? 1.0f : 0.0f;
        sHf[12 * t + k] = hf[k] * vm * dim;
    }
    sUv[2 * t] = vis ? ud : 0.0f;
    sUv[2 * t + 1] = vis ? vd : 0.0f;
    if (live) vis_out[f] = vis;
    EKF_MARK(3, hc[0] + hc[6] + hc[7] + hc[13] + hf[0] + hf[5] + hf[6]
                + hf[11]);
    __syncthreads();

    const int first = blockIdx.x * THREADS;
    const int n = min(THREADS, F - first);
    copy_out<VEC>(hc_out + 26 * (size_t)first, sHc, 26 * n);
    copy_out<VEC>(hf_out + 12 * (size_t)first, sHf, 12 * n);
    copy_out<VEC>(uv_out + 2 * (size_t)first, sUv, 2 * n);
    EKF_MARK(4, 0.0f);
}

template <bool QUIRKS>
__global__ void __launch_bounds__(THREADS)
measure_kernel(const float* __restrict__ cam7, const float* __restrict__ feats,
               const uint8_t* __restrict__ is_xyz,
               const uint8_t* __restrict__ active, float* __restrict__ uv_out,
               float* __restrict__ hc_out, float* __restrict__ hf_out,
               uint8_t* __restrict__ vis_out, int F, CamParams c) {
    measure_body<QUIRKS, true>(cam7, feats, is_xyz, active, uv_out, hc_out,
                               hf_out, vis_out, F, c);
}

// B streams stacked: blockIdx.y is the stream, whose blocks run exactly the
// single-stream body on its own slots (its outputs' 16-byte vectors only
// where every stream's start is aligned, VEC).
template <bool QUIRKS, bool VEC>
__global__ void __launch_bounds__(THREADS)
measure_kernel_batched(const float* __restrict__ cam7,
                       const float* __restrict__ feats,
                       const uint8_t* __restrict__ is_xyz,
                       const uint8_t* __restrict__ active,
                       float* __restrict__ uv_out, float* __restrict__ hc_out,
                       float* __restrict__ hf_out,
                       uint8_t* __restrict__ vis_out, int F, CamParams c) {
    const size_t s = blockIdx.y, sF = s * F;
    measure_body<QUIRKS, VEC>(cam7 + 7 * s, feats + 6 * sF, is_xyz + sF,
                              active + sF, uv_out + 2 * sF, hc_out + 26 * sF,
                              hf_out + 12 * sF, vis_out + sF, F, c);
}

}  // namespace

// ``quirks`` != 0 launches the QUIRKS instantiation.  uv, hc and hf must
// be 16-byte aligned (fresh allocations are).  B streams stacked take one
// launch of measure_kernel_batched; B = 1 the single-stream kernel.
EKF_EXPORT int ekf_measure_batched(const float* cam7, const float* feats,
                                   const uint8_t* is_xyz,
                                   const uint8_t* active, float* uv,
                                   float* hc, float* hf, uint8_t* visible,
                                   int F, int B, int quirks,
                                   const CamParams* cam, void* stream) {
    if (F < 1 || B < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (B > 1) {
        const dim3 grid((F + THREADS - 1) / THREADS, B);
        const bool vec = F % 2 == 0;   // each stream's outputs 16-byte aligned
        if (quirks && vec)
            measure_kernel_batched<true, true><<<grid, THREADS, 0, st>>>(
                cam7, feats, is_xyz, active, uv, hc, hf, visible, F, *cam);
        else if (quirks)
            measure_kernel_batched<true, false><<<grid, THREADS, 0, st>>>(
                cam7, feats, is_xyz, active, uv, hc, hf, visible, F, *cam);
        else if (vec)
            measure_kernel_batched<false, true><<<grid, THREADS, 0, st>>>(
                cam7, feats, is_xyz, active, uv, hc, hf, visible, F, *cam);
        else
            measure_kernel_batched<false, false><<<grid, THREADS, 0, st>>>(
                cam7, feats, is_xyz, active, uv, hc, hf, visible, F, *cam);
        return ekf_last_error();
    }
    const int blocks = (F + THREADS - 1) / THREADS;
    if (quirks)
        measure_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            cam7, feats, is_xyz, active, uv, hc, hf, visible, F, *cam);
    else
        measure_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
            cam7, feats, is_xyz, active, uv, hc, hf, visible, F, *cam);
    return ekf_last_error();
}

// One stream (tools/small_kernel_clocks.py calls this entry).
EKF_EXPORT int ekf_measure(const float* cam7, const float* feats,
                           const uint8_t* is_xyz, const uint8_t* active,
                           float* uv, float* hc, float* hf, uint8_t* visible,
                           int F, int quirks, const CamParams* cam,
                           void* stream) {
    return ekf_measure_batched(cam7, feats, is_xyz, active, uv, hc, hf,
                               visible, F, 1, quirks, cam, stream);
}
