// 1-point RANSAC's hypotheses and support count (filter/ransac.py
// ransac, 1PointRansac.cpp:48-84 and 101-234): for every hypothesis h, the
// state-only 1-point update from slot h's match, every slot re-predicted
// from that hypothesised state, and the slots whose match lies within the
// threshold counted.
//
// Replaces no TPU kernel: the JAX package runs RANSAC as plain XLA.  It
// was added because its plain PyTorch chain (ops/ransac_kernel.py
// support_plain: the 2x2 solve, the (F, N) hypothesised states, h(x) with
// its 11 Newton steps, the gates, the norm and the sum) is some two
// hundred launches of about 2 us of device work each, and their dispatch
// held the host for about a quarter of every live frame.
//
// Line for line the plain version, in float32:
//   - the solve of (S_h + (pixel_error - 1) I) sol = dz_h in the closed
//     form of ransac_kernel.solve2x2 (its 1e-20 determinant floor), then
//     dx = HP[2h] sol0 + HP[2h+1] sol1, times matched[h], added to x; with
//     DEADBAND (the parity mode) dz and dx through the reference's DELTA
//     deadband first (Update.cpp:133-203);
//   - h(x) as filter/measure.py measure_one: the inverse-depth or XYZ
//     point rotated into the camera, z clamped to 1 where |z| < 1e-6,
//     projected (fx px / pz), distorted by 10 + 1 Newton steps;
//   - the gates of _support_counts: in front and inside the FOV
//     (unclamped point), inside the image, and |z - uv| < threshold as the
//     norm (not its square), so a knife edge falls where the plain float32
//     chain has it.
// The h(x) code is a copy of csrc/measure.cu's, not a shared header: the
// measure kernel projects through 1 / pz, which its Jacobians reuse, and
// the plain chain divides; one header would move either the measure
// kernel's bits or this kernel's agreement with the plain version.
//
// Bound on the H100: launch latency and one thread's dependency chain.
// The bytes that must move are the two rows of H P a hypothesis reads,
// 2F (7 + 6F) floats (0.14 us at F = 96, 0.41 us at F = 168 at 3.35 TB/s),
// and the work about 400 F^2 flops.  The design:
//   - one block a hypothesis (grid F x B streams), its threads over the
//     slots (F rounded up to a warp, at most 256; a slot loop beyond), so
//     the (F, N) hypothesised states are never written;
//   - every thread solves its hypothesis's 2x2 system and forms its camera
//     and R(q)^T itself, from loads that the warp broadcasts: no barrier
//     before the slot work, whose loads overlap the solve;
//   - the Newton loop leaves as soon as every lane of the warp sits on a
//     fixed point or a two-value cycle (the result is the full loop's bit
//     for bit: csrc/measure.cu says why), and a zero step skips the
//     divide's slow path;
//   - good is written as bytes, coalesced along the row; the support is
//     each warp's ballot popcounts, summed over the block's warps through
//     shared memory.

#include "common.cuh"

namespace {

constexpr int NEWTON_ITERS = 10;
constexpr int MAX_THREADS = 256;
constexpr int CAM_DIM = 13;
constexpr float DELTA = 1.0e-12f;   // filter/update.py DELTA

// a / b, IEEE, with a zero dividend over a positive finite divisor taken
// apart (csrc/measure.cu div_step)
__device__ __forceinline__ float div_step(float a, float b) {
    if (a == 0.0f && b > 0.0f && isfinite(b)) return a;
    return a / b;
}

__device__ __forceinline__ float deadbanded(float v) {
    return fabsf(v) > DELTA ? v : 0.0f;
}

// one component of a hypothesised state: x + matched * dx
template <bool DEADBAND>
__device__ __forceinline__ float hypothesised(float x, float h0, float h1,
                                              float s0, float s1, float m) {
    float d = h0 * s0 + h1 * s1;
    if (DEADBAND) d = deadbanded(d);
    return x + d * m;
}

// The kernel's work on one stream's hypothesis blockIdx.x.
template <bool DEADBAND>
__device__ __forceinline__ void
support_body(const float* __restrict__ x, const float* __restrict__ hp,
             const float* __restrict__ S, const float* __restrict__ z,
             const float* __restrict__ uv,
             const uint8_t* __restrict__ matched,
             const uint8_t* __restrict__ active,
             const uint8_t* __restrict__ is_xyz, int* __restrict__ support,
             uint8_t* __restrict__ good, int F, int N, float diag_add,
             float threshold, CamParams c) {
    __shared__ int sWarp[MAX_THREADS / 32];
    const int h = blockIdx.x;
    const float* h0 = hp + (size_t)(2 * h) * N;
    const float* h1 = h0 + N;

    // the hypothesis: sol = (S_h + (pixel_error - 1) I)^-1 dz_h
    const float a = S[4 * h] + diag_add, b = S[4 * h + 1];
    const float d = S[4 * h + 2], e = S[4 * h + 3] + diag_add;
    float dz0 = z[2 * h] - uv[2 * h], dz1 = z[2 * h + 1] - uv[2 * h + 1];
    if (DEADBAND) {
        dz0 = deadbanded(dz0);
        dz1 = deadbanded(dz1);
    }
    float det = a * e - b * d;
    if (fabsf(det) < 1e-20f) det = 1e-20f;
    const float s0 = (e * dz0 - b * dz1) / det;
    const float s1 = (a * dz1 - d * dz0) / det;
    const float m = matched[h] ? 1.0f : 0.0f;

    // its camera: r and Rt = R(q)^T
    float cam[7];
#pragma unroll
    for (int k = 0; k < 7; ++k)
        cam[k] = hypothesised<DEADBAND>(x[k], h0[k], h1[k], s0, s1, m);
    const float w = cam[3], q1 = cam[4], q2 = cam[5], q3 = cam[6];
    const float w2 = w * w, x2 = q1 * q1, y2 = q2 * q2, z2 = q3 * q3;
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

    // lanes past F compute slot F - 1 and store nothing: every lane of a
    // warp takes part in the Newton loop's vote and the ballot
    int count = 0;   // the warp's supporting slots
    for (int base = 0; base < F; base += blockDim.x) {
        const int f = base + threadIdx.x;
        const bool live = f < F;
        const int fs = live ? f : F - 1;
        const int o = CAM_DIM + 6 * fs;
        float fe[6];
#pragma unroll
        for (int k = 0; k < 6; ++k)
            fe[k] = hypothesised<DEADBAND>(x[o + k], h0[o + k], h1[o + k],
                                           s0, s1, m);
        const bool xyz = is_xyz[fs] != 0;
        float cph, sph, cth, sth;
        sincosf(fe[4], &sph, &cph);
        sincosf(fe[3], &sth, &cth);
        const float ox = fe[0] - cam[0], oy = fe[1] - cam[1];
        const float oz = fe[2] - cam[2];
        const float rho = fe[5];
        const float ax = xyz ? ox : rho * ox + cph * sth;
        const float ay = xyz ? oy : rho * oy + (-sph);
        const float az = xyz ? oz : rho * oz + cph * cth;
        const float px = Rt[0][0] * ax + Rt[0][1] * ay + Rt[0][2] * az;
        const float py = Rt[1][0] * ax + Rt[1][1] * ay + Rt[1][2] * az;
        const float pz_raw = Rt[2][0] * ax + Rt[2][1] * ay + Rt[2][2] * az;
        const float pz = fabsf(pz_raw) < 1e-6f ? 1.0f : pz_raw;

        // projection + Newton distortion
        const float uu = c.cx + c.fx * px / pz;
        const float vu = c.cy + c.fy * py / pz;
        const float du = uu - c.cx, dv = vu - c.cy;
        const float mx = c.dx * du, my = c.dy * dv;
        const float r2m = fmaxf(mx * mx + my * my, 1e-12f);
        const float ru = sqrtf(r2m);
        float rd = ru / (1.0f + c.k1 * r2m + c.k2 * r2m * r2m);
        float prev = __uint_as_float(0xffffffffu);   // no step yields this
        for (int it = 0; it < NEWTON_ITERS; ++it) {
            const float rd2 = rd * rd;
            const float fv = rd + c.k1 * rd2 * rd + c.k2 * rd2 * rd2 * rd
                             - ru;
            const float fp = 1.0f + 3.0f * c.k1 * rd2
                             + 5.0f * c.k2 * rd2 * rd2;
            const float next = rd - div_step(fv, fp);
            const bool fixed = __float_as_uint(next) == __float_as_uint(rd);
            const bool cycle = __float_as_uint(next) == __float_as_uint(prev);
            prev = rd;
            rd = next;
            if (__all_sync(0xffffffffu, fixed || cycle)) {
                if (!fixed && ((NEWTON_ITERS - it - 1) & 1)) rd = prev;
                break;
            }
        }
        // the eleventh step
        const float rd2s = rd * rd;
        const float fvs = rd + c.k1 * rd2s * rd + c.k2 * rd2s * rd2s * rd
                          - ru;
        const float gp = 1.0f + 3.0f * c.k1 * rd2s
                         + 5.0f * c.k2 * rd2s * rd2s;
        rd = rd - div_step(fvs, gp);
        const float rd2 = rd * rd;
        const float dd = 1.0f + c.k1 * rd2 + c.k2 * rd2 * rd2;
        const float ud = c.cx + du / dd, vd = c.cy + dv / dd;

        const bool fov = (pz_raw > 0.0f) && (fabsf(px) < pz_raw * c.tan_x)
                         && (fabsf(py) < pz_raw * c.tan_y);
        const bool img = (ud > 0.0f) && (ud < c.pixels_x) && (vd > 0.0f)
                         && (vd < c.pixels_y);
        const float e0 = z[2 * fs] - ud, e1 = z[2 * fs + 1] - vd;
        const bool ok = live && matched[fs] && active[fs] && fov && img
                        && sqrtf(e0 * e0 + e1 * e1) < threshold;
        if (live) good[f] = ok;
        count += __popc(__ballot_sync(0xffffffffu, ok));
    }
    if ((threadIdx.x & 31) == 0) sWarp[threadIdx.x / 32] = count;
    __syncthreads();
    if (threadIdx.x == 0) {
        int total = 0;
        for (int k = 0; k < (int)blockDim.x / 32; ++k) total += sWarp[k];
        support[h] = total;
    }
}

// blockIdx.x is the hypothesis, blockIdx.y the stream: each stream's
// blocks run exactly the single-stream body on its own operands.
template <bool DEADBAND>
__global__ void __launch_bounds__(MAX_THREADS)
support_kernel(const float* __restrict__ x, const float* __restrict__ hp,
               const float* __restrict__ S, const float* __restrict__ z,
               const float* __restrict__ uv,
               const uint8_t* __restrict__ matched,
               const uint8_t* __restrict__ active,
               const uint8_t* __restrict__ is_xyz, int* __restrict__ support,
               uint8_t* __restrict__ good, int F, int N, float diag_add,
               float threshold, CamParams c) {
    const size_t s = blockIdx.y, sF = s * F;
    support_body<DEADBAND>(
        x + s * N, hp + 2 * sF * N, S + 4 * sF, z + 2 * sF, uv + 2 * sF,
        matched + sF, active + sF, is_xyz + sF, support + sF,
        good + (sF + blockIdx.x) * F, F, N, diag_add, threshold, c);
}

}  // namespace

// B streams stacked: x (B, N), hp (B, 2F, N), S (B, F, 2, 2), z and uv
// (B, F, 2), the three masks (B, F); support (B, F) int32, good (B, F, F)
// bytes.  diag_add is pixel_error - 1; ``deadband`` != 0 launches the
// DEADBAND instantiation.  Every slot's six parameters lie in x[13:13+6F].
EKF_EXPORT int ekf_ransac_support_batched(
    const float* x, const float* hp, const float* S, const float* z,
    const float* uv, const uint8_t* matched, const uint8_t* active,
    const uint8_t* is_xyz, int* support, uint8_t* good, int F, int N, int B,
    float diag_add, float threshold, int deadband, const CamParams* cam,
    void* stream) {
    if (F < 1 || B < 1 || B > 65535 || N < CAM_DIM + 6 * F)
        return (int)cudaErrorInvalidValue;
    const dim3 grid(F, B);
    const int warps = (F + 31) / 32;
    const int threads = warps < MAX_THREADS / 32 ? 32 * warps : MAX_THREADS;
    cudaStream_t st = (cudaStream_t)stream;
    if (deadband)
        support_kernel<true><<<grid, threads, 0, st>>>(
            x, hp, S, z, uv, matched, active, is_xyz, support, good, F, N,
            diag_add, threshold, *cam);
    else
        support_kernel<false><<<grid, threads, 0, st>>>(
            x, hp, S, z, uv, matched, active, is_xyz, support, good, F, N,
            diag_add, threshold, *cam);
    return ekf_last_error();
}

// One stream.
EKF_EXPORT int ekf_ransac_support(
    const float* x, const float* hp, const float* S, const float* z,
    const float* uv, const uint8_t* matched, const uint8_t* active,
    const uint8_t* is_xyz, int* support, uint8_t* good, int F, int N,
    float diag_add, float threshold, int deadband, const CamParams* cam,
    void* stream) {
    return ekf_ransac_support_batched(x, hp, S, z, uv, matched, active,
                                      is_xyz, support, good, F, N, 1,
                                      diag_add, threshold, deadband, cam,
                                      stream);
}
