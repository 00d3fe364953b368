// Dense BRIEF bit-planes from a shared point pool, one launch (see
// ops/brief_kernel.py).
//
// Output word w8 at interior pixel (y, x) has bit j set when
// img[y + half + dy1, x + half + dx1] < img[y + half + dy2, x + half + dx2]
// for pair 32 w8 + j = (p1, p2), (dy, dx) = points[p].  A block stages its
// BR_TILE_W x BR_TILE_H output tile of the image with a halo of `half` in
// shared memory (plain coalesced loads: the rows of odd widths are not
// 16-byte aligned); one thread a column then makes the words of its
// BR_TILE_H / BR_ROWS pixels from there and writes each word as it is
// made.  Two variants:
//
//   brief_planes_s256     the shipped pattern (brief_pattern.cuh), a
//                         template over its compile-time tables: a pixel's
//                         64 distinct samples are loaded into registers
//                         (64 shared-memory loads at immediate offsets) and
//                         its 256 compares run on registers;
//   brief_planes_generic  any pattern of up to BR_MAX_BITS bits: each bit's
//                         pair of tile offsets is a __grid_constant__
//                         kernel parameter, read from the constant bank as
//                         a uniform operand, so a bit is two shared-memory
//                         loads.
//
// Compares of float32 values are exact (a plain `<`, no sign-of-difference
// trick), so the planes equal the plain version bit for bit.  The grid
// rounds up: every interior row and column is written.

#include <utility>

#include "brief_pattern.cuh"
#include "common.cuh"

#define BR_TILE_W 64       // output columns a block: one thread each
#define BR_TILE_H 16       // output rows a block
#define BR_ROWS 4          // thread rows; a thread makes BR_TILE_H / BR_ROWS pixels
#define BR_THREADS (BR_TILE_W * BR_ROWS)
#define BR_MAX_BITS 512    // the generic variant's largest pattern

namespace {

// tile (i, j) holds img[y0 + i, x0 + j]; rows and columns past the image
// feed only outputs past the interior, which are not written
__device__ __forceinline__ void stage_tile(float* tile, const float* img,
                                           int h, int w, int y0, int x0,
                                           int tw, int th) {
    const int tid = threadIdx.y * BR_TILE_W + threadIdx.x;
    for (int k = tid; k < tw * th; k += BR_THREADS) {
        const int i = k / tw, j = k % tw;
        const int Y = y0 + i, X = x0 + j;
        tile[k] = (Y < h && X < w) ? img[(size_t)Y * w + X] : 0.0f;
    }
}

// ---- the compiled pattern

// tile offset of sample K from the pixel, and point S (0, 1) of bit B:
// scalar constants, usable in device code
template <class Pat, int K, int TW>
struct SampleAt {
    static constexpr int value = Pat::point[K][0] * TW + Pat::point[K][1];
};
template <class Pat, int B, int S>
struct PairPoint {
    static constexpr int value = Pat::pair[B][S];
};

template <class Pat, int TW, int... K>
__device__ __forceinline__ void load_samples(const float* c, float* s,
                                             std::integer_sequence<int, K...>) {
    ((s[K] = c[SampleAt<Pat, K, TW>::value]), ...);
}

template <class Pat, int W8, int... J>
__device__ __forceinline__ unsigned make_word(const float* s,
                                              std::integer_sequence<int, J...>) {
    unsigned acc = 0u;
    ((acc |= static_cast<unsigned>(s[PairPoint<Pat, 32 * W8 + J, 0>::value]
                                   < s[PairPoint<Pat, 32 * W8 + J, 1>::value])
             << J), ...);
    return acc;
}

template <class Pat, int... W8>
__device__ __forceinline__ void store_words(const float* s, int* o,
                                            size_t plane,
                                            std::integer_sequence<int, W8...>) {
    ((o[W8 * plane] = static_cast<int>(make_word<Pat, W8>(
          s, std::make_integer_sequence<int, 32>{}))), ...);
}

template <class Pat>
__device__ __forceinline__ void brief_fixed(const float* __restrict__ img,
                                            int h, int w,
                                            int* __restrict__ out) {
    constexpr int half = Pat::half;
    constexpr int TW = BR_TILE_W + 2 * half, TH = BR_TILE_H + 2 * half;
    __shared__ float tile[TH * TW];
    const int x0 = blockIdx.x * BR_TILE_W, y0 = blockIdx.y * BR_TILE_H;
    stage_tile(tile, img, h, w, y0, x0, TW, TH);
    __syncthreads();

    const int ih = h - 2 * half, iw = w - 2 * half;
    const int x = x0 + threadIdx.x;
    if (x >= iw) return;
    const size_t plane = (size_t)ih * iw;
#pragma unroll 1
    for (int r = threadIdx.y; r < BR_TILE_H; r += BR_ROWS) {
        const int y = y0 + r;
        if (y >= ih) break;
        const float* c = tile + (r + half) * TW + threadIdx.x + half;
        float s[Pat::n_points];
        load_samples<Pat, TW>(c, s,
                              std::make_integer_sequence<int, Pat::n_points>{});
        store_words<Pat>(s, out + (size_t)y * iw + x, plane,
                         std::make_integer_sequence<int, Pat::n_bits / 32>{});
    }
}

// ---- any pattern

// 4 KB of offsets at 512 bits: kernel parameters above 4 KB need CUDA 12.1
static_assert(CUDART_VERSION >= 12010,
              "the generic BRIEF variant needs CUDA 12.1 or later");

struct BriefOffsets {
    int off[BR_MAX_BITS][2];   // tile offsets of each bit's pair
};

}  // namespace

__global__ void __launch_bounds__(BR_THREADS)
brief_planes_s256(const float* __restrict__ img, int h, int w,
                  int* __restrict__ out) {
    brief_fixed<ShippedPattern>(img, h, w, out);
}

// The generic variant's work on one image (both entry points run it).
__device__ __forceinline__ void
brief_generic_body(const float* __restrict__ img, int h, int w, int half,
                   int n_words, const BriefOffsets& tab,
                   int* __restrict__ out) {
    extern __shared__ float tile[];
    const int tw = BR_TILE_W + 2 * half, th = BR_TILE_H + 2 * half;
    const int x0 = blockIdx.x * BR_TILE_W, y0 = blockIdx.y * BR_TILE_H;
    stage_tile(tile, img, h, w, y0, x0, tw, th);
    __syncthreads();

    const int ih = h - 2 * half, iw = w - 2 * half;
    const int x = x0 + threadIdx.x;
    if (x >= iw) return;
    const size_t plane = (size_t)ih * iw;
#pragma unroll 1
    for (int r = threadIdx.y; r < BR_TILE_H; r += BR_ROWS) {
        const int y = y0 + r;
        if (y >= ih) break;
        const float* c = tile + (r + half) * tw + threadIdx.x + half;
        int* o = out + (size_t)y * iw + x;
#pragma unroll
        for (int w8 = 0; w8 < BR_MAX_BITS / 32; ++w8) {
            if (w8 >= n_words) break;
            unsigned acc = 0u;
#pragma unroll
            for (int j = 0; j < 32; ++j) {
                const int b = 32 * w8 + j;
                acc |= static_cast<unsigned>(c[tab.off[b][0]]
                                             < c[tab.off[b][1]]) << j;
            }
            o[w8 * plane] = static_cast<int>(acc);
        }
    }
}

__global__ void __launch_bounds__(BR_THREADS)
brief_planes_generic(const float* __restrict__ img, int h, int w, int half,
                     int n_words, const __grid_constant__ BriefOffsets tab,
                     int* __restrict__ out) {
    brief_generic_body(img, h, w, half, n_words, tab, out);
}

// B streams' images and planes stacked: blockIdx.z is the stream, whose
// blocks run exactly the single-stream variant on its own image.
__global__ void __launch_bounds__(BR_THREADS)
brief_planes_s256_batched(const float* __restrict__ img, int h, int w,
                          int* __restrict__ out) {
    constexpr int half = ShippedPattern::half;
    const size_t s = blockIdx.z;
    brief_fixed<ShippedPattern>(
        img + s * h * w, h, w,
        out + s * (ShippedPattern::n_bits / 32) * (h - 2 * half)
                  * (w - 2 * half));
}

__global__ void __launch_bounds__(BR_THREADS)
brief_planes_generic_batched(const float* __restrict__ img, int h, int w,
                             int half, int n_words,
                             const __grid_constant__ BriefOffsets tab,
                             int* __restrict__ out) {
    const size_t s = blockIdx.z;
    brief_generic_body(img + s * h * w, h, w, half, n_words, tab,
                       out + s * n_words * (h - 2 * half) * (w - 2 * half));
}

// img: (B, h, w) float32; out: (B, 8, h - 32, w - 32) int32, the shipped
// pattern.  B = 1 launches the single-stream kernel, B > 1 one launch of
// brief_planes_s256_batched.
EKF_EXPORT int ekf_brief_batched(const float* img, int h, int w, int B,
                                 int* out, cudaStream_t stream) {
    constexpr int half = ShippedPattern::half;
    const int ih = h - 2 * half, iw = w - 2 * half;
    if (ih < 1 || iw < 1 || B < 1 || B > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((iw + BR_TILE_W - 1) / BR_TILE_W,
                    (ih + BR_TILE_H - 1) / BR_TILE_H, B);
    if (B > 1)
        brief_planes_s256_batched<<<grid, dim3(BR_TILE_W, BR_ROWS), 0,
                                    stream>>>(img, h, w, out);
    else
        brief_planes_s256<<<grid, dim3(BR_TILE_W, BR_ROWS), 0, stream>>>(
            img, h, w, out);
    return ekf_last_error();
}

EKF_EXPORT int ekf_brief(const float* img, int h, int w, int* out,
                         cudaStream_t stream) {
    return ekf_brief_batched(img, h, w, 1, out, stream);
}

// img: (B, h, w) float32; offsets: host (n_bits, 2) int32 tile offsets
// (dy (BR_TILE_W + 2 half) + dx of each bit's two points, |dy|, |dx| <=
// half); out: (B, n_bits / 32, h - 2 half, w - 2 half) int32.  B > 1
// takes one launch of brief_planes_generic_batched.
EKF_EXPORT int ekf_brief_generic_batched(const float* img, int h, int w,
                                         int half, const int* offsets,
                                         int n_bits, int B, int* out,
                                         cudaStream_t stream) {
    const int ih = h - 2 * half, iw = w - 2 * half;
    if (ih < 1 || iw < 1 || half < 0 || n_bits < 32 || n_bits % 32
        || n_bits > BR_MAX_BITS || B < 1 || B > 65535)
        return (int)cudaErrorInvalidValue;
    BriefOffsets tab = {};
    for (int b = 0; b < 2 * n_bits; ++b) tab.off[b / 2][b % 2] = offsets[b];
    const size_t smem = (size_t)(BR_TILE_W + 2 * half)
                        * (BR_TILE_H + 2 * half) * sizeof(float);
    // the single-stream kernel's limit, and the batched one's
    static size_t granted[2] = {48 * 1024, 48 * 1024};
    if (smem > granted[B > 1]) {
        const cudaError_t e = cudaFuncSetAttribute(
            B > 1 ? (const void*)brief_planes_generic_batched
                  : (const void*)brief_planes_generic,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        granted[B > 1] = smem;
    }
    const dim3 grid((iw + BR_TILE_W - 1) / BR_TILE_W,
                    (ih + BR_TILE_H - 1) / BR_TILE_H, B);
    if (B > 1)
        brief_planes_generic_batched<<<grid, dim3(BR_TILE_W, BR_ROWS), smem,
                                       stream>>>(img, h, w, half, n_bits / 32,
                                                 tab, out);
    else
        brief_planes_generic<<<grid, dim3(BR_TILE_W, BR_ROWS), smem,
                               stream>>>(img, h, w, half, n_bits / 32, tab,
                                         out);
    return ekf_last_error();
}

EKF_EXPORT int ekf_brief_generic(const float* img, int h, int w, int half,
                                 const int* offsets, int n_bits, int* out,
                                 cudaStream_t stream) {
    return ekf_brief_generic_batched(img, h, w, half, offsets, n_bits, 1, out,
                                     stream);
}
