// Dense BRIEF bit-planes from a shared point pool, one launch (see
// ops/brief_kernel.py).
//
// Output word w8 at interior pixel (y, x) has bit j set when
// img[y + half + dy1, x + half + dx1] < img[y + half + dy2, x + half + dx2]
// for pair 32 w8 + j = (p1, p2), (dy, dx) = points[p].  A block stages its
// 32 x 16 output tile of the image with a halo of `half` in shared memory;
// each thread then makes its 256 compares from there, with both offsets
// of a pair read from shared memory (the same address for every thread:
// a broadcast).  Compares of float32 values are exact, so the planes
// equal the plain version bit for bit.  The grid rounds up: every interior
// row and column is written.

#include "common.cuh"

#define BR_BW 32
#define BR_BH 16
#define BR_THREADS_Y 8

__global__ void brief_planes(const float* __restrict__ img, int h, int w,
                             int half, const int* __restrict__ points,
                             const int* __restrict__ pairs, int n_bits,
                             int* __restrict__ out) {
    extern __shared__ float smem[];
    const int tw = BR_BW + 2 * half, th = BR_BH + 2 * half;
    float* tile = smem;
    int* off = reinterpret_cast<int*>(smem + tw * th);   // 2 per pair
    const int ih = h - 2 * half, iw = w - 2 * half;
    const int x0 = blockIdx.x * BR_BW, y0 = blockIdx.y * BR_BH;
    const int tid = threadIdx.y * BR_BW + threadIdx.x;
    const int nthreads = BR_BW * BR_THREADS_Y;

    for (int b = tid; b < n_bits; b += nthreads) {
        const int p1 = pairs[2 * b], p2 = pairs[2 * b + 1];
        off[2 * b] = points[2 * p1] * tw + points[2 * p1 + 1];
        off[2 * b + 1] = points[2 * p2] * tw + points[2 * p2 + 1];
    }
    // tile (i, j) holds img[y0 + i, x0 + j]; rows and columns past the
    // image feed only outputs past the interior, which are not written
    for (int k = tid; k < tw * th; k += nthreads) {
        const int i = k / tw, j = k % tw;
        const int Y = y0 + i, X = x0 + j;
        tile[k] = (Y < h && X < w) ? img[(size_t)Y * w + X] : 0.0f;
    }
    __syncthreads();

    const int x = x0 + threadIdx.x;
    if (x >= iw) return;
    const size_t plane = (size_t)ih * iw;
    for (int r = threadIdx.y; r < BR_BH; r += BR_THREADS_Y) {
        const int y = y0 + r;
        if (y >= ih) break;
        const float* c = tile + (r + half) * tw + threadIdx.x + half;
        int* o = out + (size_t)y * iw + x;
        for (int w8 = 0; w8 < n_bits / 32; ++w8) {
            unsigned acc = 0u;
#pragma unroll 8
            for (int j = 0; j < 32; ++j) {
                const int b = 32 * w8 + j;
                acc |= (unsigned)(c[off[2 * b]] < c[off[2 * b + 1]]) << j;
            }
            o[w8 * plane] = (int)acc;
        }
    }
}

// img: (h, w) float32; points: (n_points, 2) int32 (dy, dx) with
// |dy|, |dx| <= half; pairs: (n_bits, 2) int32 indices into points;
// out: (n_bits / 32, h - 2 half, w - 2 half) int32.
EKF_EXPORT int ekf_brief(const float* img, int h, int w, int half,
                         const int* points, const int* pairs, int n_bits,
                         int* out, cudaStream_t stream) {
    const int ih = h - 2 * half, iw = w - 2 * half;
    const size_t smem = (size_t)(BR_BW + 2 * half) * (BR_BH + 2 * half)
                        * sizeof(float) + 2 * n_bits * sizeof(int);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            brief_planes, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const dim3 grid((iw + BR_BW - 1) / BR_BW, (ih + BR_BH - 1) / BR_BH);
    brief_planes<<<grid, dim3(BR_BW, BR_THREADS_Y), smem, stream>>>(
        img, h, w, half, points, pairs, n_bits, out);
    return ekf_last_error();
}
