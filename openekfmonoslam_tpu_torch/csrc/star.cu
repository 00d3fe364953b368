// STAR (CenSurE) scoring from the integral image, plus non-max
// suppression: three launches on one stream (see ops/star_kernel.py).
//
//   star_resp   integral image -> scale-max |inner mean - outer mean|
//   star_score  gradients, 5x5 structure tensor, line gate, threshold ->
//               the pre-NMS map
//   star_nms    (2r+1)^2 local-maximum test -> the NMS'd map
//
// Every rounding is written out (__fmul_rn, __fadd_rn, __fmaf_rn), so the
// compiler contracts nothing and the maps equal the plain PyTorch chain
// (vision/star.py scores_from_integral + vision/fast.py non_max_suppress)
// bit for bit.  Two edge rules meet here and must not be mixed up: the
// gradients and box sums clamp their indices (edge replication), while the
// NMS window skips pixels outside the image (-inf padding).

#include "common.cuh"

#define STAR_MAX_SIZES 14
#define STAR_FUSE_INNER 1
#define STAR_FUSE_OUTER 2

// Field order is ops/star_kernel.py's StarParams.
struct StarParams {
    int h, w, ii_w, pad, n_sizes, nms_radius;
    float response_threshold, line_threshold;
    int size[STAR_MAX_SIZES];
    int fuse[STAR_MAX_SIZES];
    float r_in[STAR_MAX_SIZES];
    float r_out[STAR_MAX_SIZES];
};

// Box sum ((A - B) - C) + D over the centred (2n+1)^2 box at (y, x).
__device__ __forceinline__ float box_sum(const float* __restrict__ ii,
                                         int ii_w, int pad, int y, int x,
                                         int n) {
    const int top = pad - n, bot = pad + n + 1;
    const float a = ii[(size_t)(y + bot) * ii_w + x + bot];
    const float b = ii[(size_t)(y + top) * ii_w + x + bot];
    const float c = ii[(size_t)(y + bot) * ii_w + x + top];
    const float d = ii[(size_t)(y + top) * ii_w + x + top];
    return __fadd_rn(__fsub_rn(__fsub_rn(a, b), c), d);
}

__global__ void star_resp(const float* __restrict__ ii, StarParams p,
                          float* __restrict__ best) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.w || y >= p.h) return;
    float m = 0.0f;
    for (int k = 0; k < p.n_sizes; ++k) {
        const int n = p.size[k];
        const float s_in = box_sum(ii, p.ii_w, p.pad, y, x, n);
        const float s_out = box_sum(ii, p.ii_w, p.pad, y, x, 2 * n);
        float r;
        if (p.fuse[k] == STAR_FUSE_INNER) {
            r = __fmaf_rn(s_in, p.r_in[k], -__fmul_rn(s_out, p.r_out[k]));
        } else if (p.fuse[k] == STAR_FUSE_OUTER) {
            r = __fmaf_rn(-s_out, p.r_out[k], __fmul_rn(s_in, p.r_in[k]));
        } else {
            r = __fsub_rn(__fmul_rn(s_in, p.r_in[k]),
                          __fmul_rn(s_out, p.r_out[k]));
        }
        m = k == 0 ? fabsf(r) : fmaxf(m, fabsf(r));
    }
    best[(size_t)y * p.w + x] = m;
}

#define SC_BW 32
#define SC_BH 8
#define SC_R 2                              // structure-tensor radius
#define SC_TW (SC_BW + 2 * SC_R)
#define SC_TH (SC_BH + 2 * SC_R)

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Separable 5x5 box sum of tile products, rows then columns, each in
// ascending offset order from 0 (vision/harris.py _box_sum).
template <typename Prod>
__device__ __forceinline__ float box5(int ty, int tx, Prod prod) {
    float out = 0.0f;
    for (int dx = 0; dx <= 2 * SC_R; ++dx) {
        float acc = 0.0f;
        for (int dy = 0; dy <= 2 * SC_R; ++dy)
            acc = __fadd_rn(acc, prod(ty + dy, tx + dx));
        out = __fadd_rn(out, acc);
    }
    return out;
}

__global__ void star_score(const float* __restrict__ best, StarParams p,
                           float* __restrict__ raw) {
    // rx, ry at the clamped positions (clamp(y0 - 2 + i), clamp(x0 - 2 + j))
    __shared__ float rx[SC_TH][SC_TW];
    __shared__ float ry[SC_TH][SC_TW];
    const int x0 = blockIdx.x * SC_BW, y0 = blockIdx.y * SC_BH;
    const int tid = threadIdx.y * SC_BW + threadIdx.x;
    for (int k = tid; k < SC_TH * SC_TW; k += SC_BW * SC_BH) {
        const int i = k / SC_TW, j = k % SC_TW;
        const int Y = clampi(y0 - SC_R + i, 0, p.h - 1);
        const int X = clampi(x0 - SC_R + j, 0, p.w - 1);
        const float* row = best + (size_t)Y * p.w;
        rx[i][j] = __fmul_rn(0.5f, __fsub_rn(row[clampi(X + 1, 0, p.w - 1)],
                                             row[clampi(X - 1, 0, p.w - 1)]));
        ry[i][j] = __fmul_rn(
            0.5f, __fsub_rn(best[(size_t)clampi(Y + 1, 0, p.h - 1) * p.w + X],
                            best[(size_t)clampi(Y - 1, 0, p.h - 1) * p.w + X]));
    }
    __syncthreads();
    const int x = x0 + threadIdx.x, y = y0 + threadIdx.y;
    if (x >= p.w || y >= p.h) return;
    const int ty = threadIdx.y, tx = threadIdx.x;
    const float sxx = box5(ty, tx, [&](int i, int j) {
        return __fmul_rn(rx[i][j], rx[i][j]); });
    const float syy = box5(ty, tx, [&](int i, int j) {
        return __fmul_rn(ry[i][j], ry[i][j]); });
    const float sxy = box5(ty, tx, [&](int i, int j) {
        return __fmul_rn(rx[i][j], ry[i][j]); });
    const float det = __fsub_rn(__fmul_rn(sxx, syy), __fmul_rn(sxy, sxy));
    const float tr = __fadd_rn(sxx, syy);
    const bool not_line =
        det > 0.0f && __fmul_rn(tr, tr) < __fmul_rn(p.line_threshold, det);
    const float b = not_line ? best[(size_t)y * p.w + x] : 0.0f;
    raw[(size_t)y * p.w + x] = b >= p.response_threshold ? b : 0.0f;
}

__global__ void star_nms(const float* __restrict__ raw, StarParams p,
                         float* __restrict__ nms) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= p.w || y >= p.h) return;
    const int r = p.nms_radius;
    const float c = raw[(size_t)y * p.w + x];
    float pooled = c;
    for (int yy = max(y - r, 0); yy <= min(y + r, p.h - 1); ++yy)
        for (int xx = max(x - r, 0); xx <= min(x + r, p.w - 1); ++xx)
            pooled = fmaxf(pooled, raw[(size_t)yy * p.w + xx]);
    nms[(size_t)y * p.w + x] = (c >= pooled && c > 0.0f) ? c : 0.0f;
}

// ii: (h + 2 pad + 1, ii_w) integral image; best: (h, w) scratch;
// raw, nms: (h, w) outputs.
EKF_EXPORT int ekf_star(const float* ii, const StarParams* params,
                        float* best, float* raw, float* nms,
                        cudaStream_t stream) {
    const StarParams p = *params;
    const dim3 block(32, 8);
    const dim3 grid((p.w + 31) / 32, (p.h + 7) / 8);
    star_resp<<<grid, block, 0, stream>>>(ii, p, best);
    star_score<<<dim3((p.w + SC_BW - 1) / SC_BW, (p.h + SC_BH - 1) / SC_BH),
                 dim3(SC_BW, SC_BH), 0, stream>>>(best, p, raw);
    star_nms<<<grid, block, 0, stream>>>(raw, p, nms);
    return ekf_last_error();
}
