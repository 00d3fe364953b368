// STAR (CenSurE) scoring from the integral image through the non-max
// suppression, in one launch (see ops/star_kernel.py).
//
// A block of STAR_THREADS threads owns an output tile of STAR_TILE_H rows
// and STAR_FRAME_W - 2e columns, e = 3 + r (r the NMS radius), and works
// in shared memory on a local frame of STAR_TILE_H + 2e rows and
// STAR_FRAME_W columns around it: frame (i, j) is image pixel
// (y0 - e + i, x0 - e + j).  The stages, each on the part of the frame
// that the next one reads:
//
//   A  best: the scale-max |inner mean - outer mean|     the whole frame
//   B  rx, ry: central differences of best                rows, cols 1 .. -1
//   C  vertical 5-sums of rx rx, ry ry, rx ry   \
//   D  horizontal 5-sums, det, trace, line gate  | one pass, rows 3 .. -3;
//      and threshold: the pre-NMS map raw        | C's sums stay in
//   E1 the row max of raw over |dj| <= r        /  registers
//   E2 the column max over |di| <= r and the test: nms    the tile; raw
//                                                         and nms written
//
// Edge rules, the plain chain's (vision/star.py scores_from_integral,
// vision/fast.py non_max_suppress).  The gradients and box sums clamp
// their indices (edge replication): stages A to C make, at a frame pixel
// outside the image, the value at its clamped pixel, so a read of a
// neighbour needs no clamp.  The NMS skips pixels outside the image:
// raw is -inf there, which never wins a max (raw >= 0 inside).
//
// Stage A loads each distinct box sum once: a size's inner box is mostly
// an earlier size's outer box (2 -> 1, 4 -> 2, 6 -> 3, ...), so the s3
// ladder of 8 sizes takes 11 box sums, 44 loads a pixel.  It reads the
// integral image one of two ways, picked on the host (ops/star_kernel.py
// star_plan): star_tile_staged first copies the window its boxes reach
// into shared memory, with aligned 16-byte loads (the integral image's
// rows are not 16-byte aligned, so a TMA tensor map refuses them), and
// is instantiated for each number of sizes, so the window's row stride
// and every corner offset are compile-time constants; star_tile_direct
// reads the integral image through the read-only path where the window
// does not fit.  Stages B to E1 work on 4 aligned columns a thread
// (16-byte shared-memory accesses); in the C-D-E1 pass the 16 quads of a
// frame row are a half warp, and a quad takes its neighbours' columns by
// shuffle.
//
// Every rounding is written out (__fmul_rn, __fadd_rn, __fmaf_rn) and the
// sums keep the plain chain's order, so the compiler contracts nothing
// and both maps equal the plain version bit for bit.

#include "common.cuh"

#define STAR_MAX_SIZES 14
#define STAR_FUSE_INNER 1
#define STAR_FUSE_OUTER 2
#define STAR_TILE_H 44          // output rows a block (132 blocks at 640x480)
#define STAR_FRAME_W 64         // frame columns: the output tile and 2e
#define STAR_THREADS 1024
#define STAR_SMEM_MAX (227 * 1024)   // the H100's opt-in limit a block
#define STAR_STAGED_SIZES 10    // the most sizes whose window fits (max size 44)
#define STAR_STAGE_BATCH 4      // 16-byte loads a thread has in flight

// Field order is ops/star_kernel.py's StarParams.
struct StarParams {
    int h, w, ii_w, pad, n_sizes, nms_radius;
    float response_threshold, line_threshold;
    int size[STAR_MAX_SIZES];
    int fuse[STAR_MAX_SIZES];
    float r_in[STAR_MAX_SIZES];
    float r_out[STAR_MAX_SIZES];
};

namespace {

constexpr float kNegInf = -__builtin_huge_valf();

// The frame's rows [ilo, ihi) and columns [jlo, jhi) lie inside the image.
struct Frame {
    int fy, fx, fh, ilo, ihi, jlo, jhi;
    __device__ int cy(int i) const { return min(max(i, ilo), ihi - 1); }
    __device__ int cx(int j) const { return min(max(j, jlo), jhi - 1); }
};

// The scale ladder (vision/star.py SCALE_LADDER): the sizes of any
// setting are its first n_sizes entries, which ekf_star checks.
__host__ __device__ constexpr int ladder(int k) {
    constexpr int n[STAR_MAX_SIZES] = {1, 2, 3, 4, 6, 8, 11, 16, 22, 32,
                                       45, 64, 90, 128};
    return n[k];
}

// The earlier size whose outer box (2n) is size k's inner box, or -1:
// that box sum is loaded once and serves both responses.
__host__ __device__ constexpr int inner_is_outer_of(int k) {
    for (int j = 0; j < k; ++j)
        if (2 * ladder(j) == ladder(k)) return j;
    return -1;
}

// ((A - B) - C) + D over the centred (2M+1)^2 box of one pixel: in the
// staged window, whose row stride WS and the integral image's pad PAD
// are compile-time constants, so every corner is an immediate offset
// from the pixel's c ...
template <int WS, int PAD>
struct StagedBoxes {
    const float* c;     // the window at corner offset (1, 1) of the pixel
    template <int M>
    __device__ __forceinline__ float sum() const {
        constexpr int top = PAD - M - 1, bot = PAD + M;
        return __fadd_rn(__fsub_rn(__fsub_rn(c[bot * WS + bot],
                                             c[top * WS + bot]),
                                   c[bot * WS + top]),
                         c[top * WS + top]);
    }
};

// ... or in the integral image through the read-only path
struct DirectBoxes {
    const float* ii;
    int stride, row, col, pad;
    template <int M>
    __device__ __forceinline__ float sum() const {
        const int top = pad - M, bot = pad + M + 1;
        const float a = __ldg(ii + (row + bot) * stride + col + bot);
        const float b = __ldg(ii + (row + top) * stride + col + bot);
        const float c = __ldg(ii + (row + bot) * stride + col + top);
        const float d = __ldg(ii + (row + top) * stride + col + top);
        return __fadd_rn(__fsub_rn(__fsub_rn(a, b), c), d);
    }
};

// The scale-max |response| of sizes K .. NS-1 (and below p.n_sizes;
// m holds that of sizes 0 .. K-1), each response rounded as p.fuse[K]
// says.
template <int NS, int K, class Boxes>
__device__ __forceinline__ float response(const Boxes& bx,
                                          const StarParams& p, float m,
                                          float (&outer)[STAR_MAX_SIZES]) {
    if constexpr (K == NS) {
        return m;
    } else {
        if (K >= p.n_sizes) return m;
        constexpr int n = ladder(K), from = inner_is_outer_of(K);
        float s_in;
        if constexpr (from >= 0)
            s_in = outer[from];
        else
            s_in = bx.template sum<n>();
        const float s_out = bx.template sum<2 * n>();
        outer[K] = s_out;
        float r;
        if (p.fuse[K] == STAR_FUSE_INNER) {
            r = __fmaf_rn(s_in, p.r_in[K], -__fmul_rn(s_out, p.r_out[K]));
        } else if (p.fuse[K] == STAR_FUSE_OUTER) {
            r = __fmaf_rn(-s_out, p.r_out[K], __fmul_rn(s_in, p.r_in[K]));
        } else {
            r = __fsub_rn(__fmul_rn(s_in, p.r_in[K]),
                          __fmul_rn(s_out, p.r_out[K]));
        }
        return response<NS, K + 1>(bx, p,
                                   K == 0 ? fabsf(r) : fmaxf(m, fabsf(r)),
                                   outer);
    }
}

template <int NS, class Boxes>
__device__ __forceinline__ float best_of(const Boxes& bx,
                                         const StarParams& p) {
    float outer[STAR_MAX_SIZES];
    return response<NS, 0>(bx, p, 0.0f, outer);
}

// out[i * STAR_FRAME_W + j] = fn(i, j) for every pixel of frame rows
// [i0, i1), the block's threads spread along whole frame rows
template <class Fn>
__device__ __forceinline__ void each_pixel(float* out, int i0, int i1,
                                           Fn fn) {
    for (int k = i0 * STAR_FRAME_W + (int)threadIdx.x;
         k < i1 * STAR_FRAME_W; k += STAR_THREADS)
        out[k] = fn(k / STAR_FRAME_W, k % STAR_FRAME_W);
}

__device__ __forceinline__ float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void ld4a(float (&w)[4], const float* p) {
    const float4 a = ld4(p);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
}

// The ordered 5-sum ((((0 + w[k-2]) + w[k-1]) + w[k]) + w[k+1]) + w[k+2]
__device__ __forceinline__ float sum5(const float* w) {
    float s = 0.0f;
#pragma unroll
    for (int d = 0; d < 5; ++d) s = __fadd_rn(s, w[d]);
    return s;
}

// The line gate and threshold of one pixel from its structure tensor
__device__ __forceinline__ float gate(float sxx, float syy, float sxy,
                                      float best, const StarParams& p) {
    const float det = __fsub_rn(__fmul_rn(sxx, syy), __fmul_rn(sxy, sxy));
    const float tr = __fadd_rn(sxx, syy);
    const bool not_line = det > 0.0f
        && __fmul_rn(tr, tr) < __fmul_rn(p.line_threshold, det);
    const float b = not_line ? best : 0.0f;
    return b >= p.response_threshold ? b : 0.0f;
}

// w = the row's columns c - 2 .. c + 5 of a map whose columns c .. c + 3
// this lane holds in v, the rest from the lanes of the quads beside it
// (16 quads to a half warp; the frame's edge quads take their own values,
// which no pixel of a stage's region reads)
__device__ __forceinline__ void neighbours2(float (&w)[8], const float (&v)[4]) {
    w[0] = __shfl_up_sync(0xffffffffu, v[2], 1, 16);
    w[1] = __shfl_up_sync(0xffffffffu, v[3], 1, 16);
    w[2] = v[0]; w[3] = v[1]; w[4] = v[2]; w[5] = v[3];
    w[6] = __shfl_down_sync(0xffffffffu, v[0], 1, 16);
    w[7] = __shfl_down_sync(0xffffffffu, v[1], 1, 16);
}

// w = columns c - 4 .. c + 7, the same way
__device__ __forceinline__ void neighbours4(float (&w)[12], const float (&v)[4]) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        w[t] = __shfl_up_sync(0xffffffffu, v[t], 1, 16);
        w[t + 4] = v[t];
        w[t + 8] = __shfl_down_sync(0xffffffffu, v[t], 1, 16);
    }
}

// row[t] = v[t] for the columns c + t in [j0, j1)
__device__ __forceinline__ void store_cols(float* row, const float (&v)[4],
                                           int c, int j0, int j1) {
    if (c >= j0 && c + 3 < j1) {
        st4(row, v);
    } else {
#pragma unroll
        for (int t = 0; t < 4; ++t)
            if (c + t >= j0 && c + t < j1) row[t] = v[t];
    }
}

// win[a * ws + b] = src[a * ld + b] for a < wh, b < ww, read as the
// aligned 16-byte chunks that cover each row (the integral image's rows
// are not 16-byte aligned, so neither cp.async of 16 bytes nor a TMA
// tensor map can copy them); a thread issues STAR_STAGE_BATCH loads
// before it stores any.
__device__ __forceinline__ void stage_window(float* win, int ws,
                                             const float* __restrict__ src,
                                             int ld, int wh, int ww) {
    const int cpr = (ww + 6) / 4;       // chunks a row, up to 3 floats ahead
    const int n = wh * cpr;
    // t / cpr as a multiply-high: exact for t < 2^32 / cpr
    const unsigned inv = 0xffffffffu / (unsigned)cpr + 1u;
    for (int t0 = (int)threadIdx.x; t0 < n;
         t0 += STAR_STAGE_BATCH * STAR_THREADS) {
        float4 v[STAR_STAGE_BATCH];
        int row[STAR_STAGE_BATCH], col[STAR_STAGE_BATCH];
#pragma unroll
        for (int k = 0; k < STAR_STAGE_BATCH; ++k) {
            const int t = min(t0 + k * STAR_THREADS, n - 1);
            const int a = (int)__umulhi((unsigned)t, inv), c = t - a * cpr;
            const float* line = src + (size_t)a * ld;
            const int lead = (int)(reinterpret_cast<uintptr_t>(line)
                                   / sizeof(float) % 4);
            row[k] = a;
            col[k] = 4 * c - lead;
            v[k] = __ldg(reinterpret_cast<const float4*>(line - lead) + c);
        }
#pragma unroll
        for (int k = 0; k < STAR_STAGE_BATCH; ++k) {
            if (t0 + k * STAR_THREADS >= n) break;
            float* d = win + row[k] * ws;
            const int b = col[k];
            if (b >= 0 && b < ww) d[b] = v[k].x;
            if (b + 1 >= 0 && b + 1 < ww) d[b + 1] = v[k].y;
            if (b + 2 >= 0 && b + 2 < ww) d[b + 2] = v[k].z;
            if (b + 3 < ww) d[b + 3] = v[k].w;
        }
    }
}

// The window's row stride for the integral image's pad: its widest row
__host__ __device__ constexpr int window_stride(int pad) {
    return STAR_FRAME_W + 2 * pad - 1;
}

// Stage A of the staged route with the ladder's first NS sizes: the
// window's row stride and every box offset are compile-time constants.
template <int NS>
__device__ __forceinline__ void staged_best(float* best, float* win,
                                            const float* __restrict__ ii,
                                            const Frame& f,
                                            const StarParams& p) {
    constexpr int PAD = 2 * ladder(NS - 1) + 1;
    constexpr int WS = window_stride(PAD);
    // window (a, b) = ii[fy + ilo + 1 + a][fx + jlo + 1 + b]: a box corner
    // of frame pixel (i, j) is at a = i - ilo - 1 + o, 1 <= o <= 2 PAD
    stage_window(win, WS,
                 ii + (size_t)(f.fy + f.ilo + 1) * p.ii_w + f.fx + f.jlo + 1,
                 p.ii_w, f.ihi - f.ilo + 2 * PAD - 1,
                 f.jhi - f.jlo + 2 * PAD - 1);
    __syncthreads();
    each_pixel(best, 0, f.fh, [&](int i, int j) {
        const StagedBoxes<WS, PAD> bx{win + (f.cy(i) - f.ilo) * WS
                                      + (f.cx(j) - f.jlo)};
        return best_of<NS>(bx, p);
    });
}

template <bool STAGED>
__device__ __forceinline__ void star_tile(const float* __restrict__ ii,
                                          const StarParams& p,
                                          float* __restrict__ raw_out,
                                          float* __restrict__ nms_out) {
    extern __shared__ float smem[];
    constexpr int FW = STAR_FRAME_W;
    const int r = p.nms_radius, e = 3 + r;
    Frame f;
    f.fh = STAR_TILE_H + 2 * e;
    f.fy = (int)blockIdx.y * STAR_TILE_H - e;
    f.fx = (int)blockIdx.x * (FW - 2 * e) - e;
    f.ilo = max(0, -f.fy);
    f.ihi = min(f.fh, p.h - f.fy);
    f.jlo = max(0, -f.fx);
    f.jhi = min(FW, p.w - f.fx);
    const int plane = f.fh * FW;
    float* best = smem;
    // staged: the integral-image window, which stage B then overwrites
    float* work = smem + plane;
    float* rx = work;
    float* ry = work + plane;
    float* raw = work + 2 * plane;
    float* rowmax = work + 3 * plane;

    // A: best over the frame, at the clamped pixel outside the image
    if constexpr (STAGED) {
        switch (p.n_sizes) {
#define STAR_STAGED_CASE(ns) \
        case ns: staged_best<ns>(best, work, ii, f, p); break;
        STAR_STAGED_CASE(1) STAR_STAGED_CASE(2) STAR_STAGED_CASE(3)
        STAR_STAGED_CASE(4) STAR_STAGED_CASE(5) STAR_STAGED_CASE(6)
        STAR_STAGED_CASE(7) STAR_STAGED_CASE(8) STAR_STAGED_CASE(9)
        STAR_STAGED_CASE(STAR_STAGED_SIZES)
#undef STAR_STAGED_CASE
        }
    } else {
        each_pixel(best, 0, f.fh, [&](int i, int j) {
            const DirectBoxes bx{ii, p.ii_w, f.fy + f.cy(i), f.fx + f.cx(j),
                                 p.pad};
            return best_of<STAR_MAX_SIZES>(bx, p);
        });
    }
    __syncthreads();

    // B: rx, ry on frame rows [1, fh - 1), a quad of 4 columns a thread
    // (16 quads to a half warp, the columns beside a quad by shuffle).
    // From here on a map of the frame holds, at a pixel outside the image,
    // its value at the clamped pixel.
    for (int u = (int)threadIdx.x; u < ((f.fh - 2) * 16 + 31) / 32 * 32;
         u += STAR_THREADS) {
        const bool row_ok = 1 + (u >> 4) < f.fh - 1;
        const int i = min(1 + (u >> 4), f.fh - 2), c = 4 * (u & 15);
        const float* b = best + f.cy(i) * FW;
        float mid[4], w[8], gx[4], gy[4];
        ld4a(mid, b + c);
        neighbours2(w, mid);
        if (c >= f.jlo && c + 3 < f.jhi) {
            float up[4], dn[4];
            ld4a(up, b - FW + c);
            ld4a(dn, b + FW + c);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                gx[t] = __fmul_rn(0.5f, __fsub_rn(w[t + 3], w[t + 1]));
                gy[t] = __fmul_rn(0.5f, __fsub_rn(dn[t], up[t]));
            }
        } else {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const float* q = b + f.cx(c + t);
                gx[t] = __fmul_rn(0.5f, __fsub_rn(q[1], q[-1]));
                gy[t] = __fmul_rn(0.5f, __fsub_rn(q[FW], q[-FW]));
            }
        }
        if (row_ok) {
            store_cols(rx + i * FW + c, gx, c, 1, FW - 1);
            store_cols(ry + i * FW + c, gy, c, 1, FW - 1);
        }
    }
    __syncthreads();

    // C, D and E's row max in one pass, on frame rows [3, fh - 3): a
    // thread takes a quad of 4 columns of a row, 16 quads to a row (a half
    // warp), and the horizontal sums and the row max read the neighbouring
    // quads' values from the neighbouring lanes.  The quads at the frame's
    // edges make values that no pixel of the region reads.  raw is -inf
    // outside the image, where it never wins the NMS (raw >= 0 inside).
    const auto inside = [&](int i, int j) {
        return i >= f.ilo && i < f.ihi && j >= f.jlo && j < f.jhi;
    };
    const int n_quads = ((f.fh - 6) * 16 + 31) / 32 * 32;   // whole warps
    for (int u = (int)threadIdx.x; u < n_quads; u += STAR_THREADS) {
        const bool row_ok = 3 + (u >> 4) < f.fh - 3;
        const int i = min(3 + (u >> 4), f.fh - 4), c = 4 * (u & 15);
        // C: the vertical sums of the products at the clamped pixels
        const int ci = f.cy(i);
        float sxx[4] = {}, syy[4] = {}, sxy[4] = {};
        if (c >= f.jlo && c + 3 < f.jhi) {
#pragma unroll
            for (int d = -2; d <= 2; ++d) {
                float gx[4], gy[4];
                ld4a(gx, rx + (ci + d) * FW + c);
                ld4a(gy, ry + (ci + d) * FW + c);
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                    sxx[t] = __fadd_rn(sxx[t], __fmul_rn(gx[t], gx[t]));
                    syy[t] = __fadd_rn(syy[t], __fmul_rn(gy[t], gy[t]));
                    sxy[t] = __fadd_rn(sxy[t], __fmul_rn(gx[t], gy[t]));
                }
            }
        } else {
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const int q = ci * FW + f.cx(c + t);
#pragma unroll
                for (int d = -2; d <= 2; ++d) {
                    const float gx = rx[q + d * FW], gy = ry[q + d * FW];
                    sxx[t] = __fadd_rn(sxx[t], __fmul_rn(gx, gx));
                    syy[t] = __fadd_rn(syy[t], __fmul_rn(gy, gy));
                    sxy[t] = __fadd_rn(sxy[t], __fmul_rn(gx, gy));
                }
            }
        }
        // D: the horizontal sums, the line gate and the threshold
        float wxx[8], wyy[8], wxy[8], b[4], out[4];
        neighbours2(wxx, sxx);
        neighbours2(wyy, syy);
        neighbours2(wxy, sxy);
        ld4a(b, best + i * FW + c);
#pragma unroll
        for (int t = 0; t < 4; ++t)
            out[t] = inside(i, c + t)
                ? gate(sum5(wxx + t), sum5(wyy + t), sum5(wxy + t), b[t], p)
                : kNegInf;
        if (row_ok) store_cols(raw + i * FW + c, out, c, 3, FW - 3);
        // E's row max, where r <= 4 (else its own pass, below)
        if (r <= 4) {
            float w[12], m[4];
            neighbours4(w, out);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                m[t] = w[t + 4];
#pragma unroll
                for (int k = 1; k <= 4; ++k)
                    if (k <= r) m[t] = fmaxf(m[t], fmaxf(w[t + 4 - k],
                                                         w[t + 4 + k]));
            }
            if (row_ok) store_cols(rowmax + i * FW + c, m, c, e, FW - e);
        }
    }
    __syncthreads();
    if (r > 4) {
        each_pixel(rowmax, 3, f.fh - 3, [&](int i, int j) {
            const float* row = raw + i * FW + j;
            if (j < e || j >= FW - e) return row[0];   // never read
            float m = row[0];
            for (int k = 1; k <= r; ++k)
                m = fmaxf(m, fmaxf(row[-k], row[k]));
            return m;
        });
        __syncthreads();
    }

    // one pixel a thread, so that neighbouring threads store neighbouring
    // pixels
    const int j0 = max(f.jlo, e), j1 = min(f.jhi, FW - e);
    for (int k = max(f.ilo, e) * FW + (int)threadIdx.x;
         k < min(f.ihi, e + STAR_TILE_H) * FW; k += STAR_THREADS) {
        const int i = k / FW, j = k % FW;
        if (j < j0 || j >= j1) continue;
        const float c = raw[k];
        float pooled = fmaxf(c, rowmax[k]);
#pragma unroll
        for (int a = 1; a <= 4; ++a)
            if (a <= r)
                pooled = fmaxf(pooled, fmaxf(rowmax[k - a * FW],
                                             rowmax[k + a * FW]));
        for (int a = 5; a <= r; ++a)
            pooled = fmaxf(pooled, fmaxf(rowmax[k - a * FW],
                                         rowmax[k + a * FW]));
        const size_t o = (size_t)(f.fy + i) * p.w + (f.fx + j);
        raw_out[o] = c;
        nms_out[o] = (c >= pooled && c > 0.0f) ? c : 0.0f;
    }
}

}  // namespace

__global__ void __launch_bounds__(STAR_THREADS)
star_tile_staged(const float* __restrict__ ii,
                 const __grid_constant__ StarParams p,
                 float* __restrict__ raw, float* __restrict__ nms) {
    star_tile<true>(ii, p, raw, nms);
}

__global__ void __launch_bounds__(STAR_THREADS)
star_tile_direct(const float* __restrict__ ii,
                 const __grid_constant__ StarParams p,
                 float* __restrict__ raw, float* __restrict__ nms) {
    star_tile<false>(ii, p, raw, nms);
}

// B streams' integral images and maps stacked: blockIdx.z is the stream,
// whose blocks run exactly the single-stream tile on its own image.
template <bool STAGED>
__global__ void __launch_bounds__(STAR_THREADS)
star_tile_batched(const float* __restrict__ ii,
                  const __grid_constant__ StarParams p,
                  float* __restrict__ raw, float* __restrict__ nms) {
    const size_t s = blockIdx.z, map = (size_t)p.h * p.w;
    star_tile<STAGED>(ii + s * (p.h + 2 * p.pad + 1) * p.ii_w, p,
                      raw + s * map, nms + s * map);
}

// ii: (B, h + 2 pad + 1, ii_w) integral images; raw, nms: (B, h, w)
// outputs; staged: 1 for star_tile_staged, 0 for star_tile_direct.  B = 1
// launches the single-stream kernel, B > 1 star_tile_batched: one launch.
EKF_EXPORT int ekf_star_batched(const float* ii, const StarParams* params,
                                int staged, int B, float* raw, float* nms,
                                cudaStream_t stream) {
    const StarParams p = *params;
    const int e = 3 + p.nms_radius, tw = STAR_FRAME_W - 2 * e;
    if (B < 1 || B > 65535 || p.nms_radius < 0 || tw < 1 || p.h < 1
        || p.w < 1 || p.n_sizes < 1
        || p.n_sizes > STAR_MAX_SIZES
        || p.pad != 2 * ladder(p.n_sizes - 1) + 1)
        return (int)cudaErrorInvalidValue;
    for (int k = 0; k < p.n_sizes; ++k)
        if (p.size[k] != ladder(k)) return (int)cudaErrorInvalidValue;
    const size_t plane = (size_t)(STAR_TILE_H + 2 * e) * STAR_FRAME_W;
    const size_t window = (size_t)(STAR_TILE_H + 2 * e + 2 * p.pad - 1)
                          * window_stride(p.pad);
    const size_t work = staged && window > 4 * plane ? window : 4 * plane;
    const size_t smem = (plane + work) * sizeof(float);
    if (smem > STAR_SMEM_MAX || (staged && p.n_sizes > STAR_STAGED_SIZES))
        return (int)cudaErrorInvalidValue;
    // the single-stream and the batched kernel of each route
    static size_t granted[4] = {48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024};
    const int k = (staged != 0) + 2 * (B > 1);
    if (smem > granted[k]) {
        const void* fns[4] = {(const void*)star_tile_direct,
                              (const void*)star_tile_staged,
                              (const void*)star_tile_batched<false>,
                              (const void*)star_tile_batched<true>};
        const cudaError_t err = cudaFuncSetAttribute(
            fns[k], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        granted[k] = smem;
    }
    const dim3 grid((p.w + tw - 1) / tw,
                    (p.h + STAR_TILE_H - 1) / STAR_TILE_H);
    if (B > 1) {
        const dim3 grid_b(grid.x, grid.y, B);
        if (staged)
            star_tile_batched<true><<<grid_b, STAR_THREADS, smem, stream>>>(
                ii, p, raw, nms);
        else
            star_tile_batched<false><<<grid_b, STAR_THREADS, smem, stream>>>(
                ii, p, raw, nms);
        return ekf_last_error();
    }
    if (staged)
        star_tile_staged<<<grid, STAR_THREADS, smem, stream>>>(ii, p, raw, nms);
    else
        star_tile_direct<<<grid, STAR_THREADS, smem, stream>>>(ii, p, raw, nms);
    return ekf_last_error();
}

// One stream.
EKF_EXPORT int ekf_star(const float* ii, const StarParams* params,
                        int staged, float* raw, float* nms,
                        cudaStream_t stream) {
    return ekf_star_batched(ii, params, staged, 1, raw, nms, stream);
}
