// New-landmark initialization and the covariance augmentation of the add
// path, as two launches on one stream with no host synchronisation.
//
// Replaces the TPU kernel _init_kernel / init_chain_pallas
// (openekfmonoslam_tpu/ops/init_kernel.py:48,138) and the covariance work
// its caller runs after it as XLA einsums and scatters
// (openekfmonoslam_tpu/filter/features.py:177-224; the port's plain
// version is ops/init_kernel.py add_covariance_plain):
//
//   (A) init_chain    per candidate pixel, the inverse-depth feature
//                     (anchor = camera position, bearing angles theta,
//                     phi, rho0) and its hand-derived Jacobians
//                     J1 = d(feat)/d(r, q) (6x7) and J2 = d(feat)/d(u, v,
//                     rho) (6x3): undistort (one-shot polynomial) ->
//                     back-project -> rotate by R(q) -> theta = atan2(gx,
//                     gz), phi = atan2(-gy, |(gx, gz)|), with the closed-
//                     form gradients of each step (Mosaic had no atan2, so
//                     the TPU caller took the angles outside its kernel).
//                     With P given, also the compact operands of (B), from
//                     P's camera block P77 alone: G = rows 3:5 of J1 at
//                     columns 3:7 (rows 0:3 of J1 are [I3 | 0], row 5 is
//                     zero), B = J1 P77 (6x7), and the candidate's own
//                     block D = B J1^T + J2 diag(r_add) J2^T (6x6).
//   (B) init_augment  P_new (N, N), out of place, by elements: with
//                     map[k] the (candidate, row) that writes state dim k
//                     (13 + 6 slot + row for each valid candidate, the
//                     higher candidate winning a dim two name), element
//                     (r, n) is
//                       P[r, n]                    neither r nor n mapped
//                       (J1_c P[:7, :])[i, n]      r -> (c, i), n not
//                       (J1_d P[:7, :])[j, r]      n -> (d, j), r not
//                       M(d, c)[j, i]              r -> (c, i), n -> (d, j)
//                     with M(d, c) = B_d J1_c^T for d != c and D_d for
//                     d = c: the plain version's rows and their transposes
//                     placed by its index map, the column's candidate
//                     giving the value where both are new.  Invalid
//                     candidates write nothing.  Two valid candidates on
//                     one slot come only from an injection log that names
//                     a slot twice in a frame (eval/replay.py passes a
//                     frame's entries as they are; assign_slots never
//                     does): the higher one wins, as in the plain version
//                     on the CPU, whose later index assignment wins.
//
// Sum order (the plain version's einsums sum in cuBLAS's order, so P_new
// may differ from it in the last bits): every product of J1 runs over
// its four non-zero columns 3..6 as g3 p3, then multiply-adds of g4 p4,
// g5 p5, g6 p6 in that order (__fmul_rn / __fmaf_rn, no contraction left
// to the compiler); the rows 0:3 of J1 select, row 5 gives zero.  The
// noise term of D is (J2[i][0] r0) J2[j][0] + (J2[i][1] r1) J2[j][1] on
// rows 3:5 and r2 at (5, 5), added to (B J1^T)[i][j] last.
//
// Bound on the H100: bytes, for (B): P is read once and P_new written
// once, 2 N^2 4 B (0.98 us at N = 640, 2.5 us at N = 1024, at 3.35 TB/s);
// (A) moves ~1.2 KB a candidate and is launch bound.  Design:
//   (A) 32 candidates a CTA of 128 threads; R(q) (9 threads) and P77 are
//       formed once a CTA, while each thread's pixel and the pose are
//       already on their way; a thread runs one candidate's chain and
//       writes its outputs to shared memory, which the whole CTA then
//       stores in coalesced 16-byte vectors.
//   (B) two roles in one grid.  A copy block per 4096 elements of P (16
//       elements a thread, in 16-byte vectors when N % 4 == 0 and P is
//       aligned) issues its loads first, with those of every candidate's
//       G and of P[:7, r] of its rows (volatile, so that the compiler
//       cannot sink them past the map's barriers), builds the dim ->
//       (candidate, row) map in shared memory from slots and ok (N ints
//       set to -1, then an atomicMax of 6 c + row at each valid
//       candidate's dims: the higher candidate wins) and the list of new
//       dims, and only then stages the loaded values in shared memory,
//       P's in a tile of its 4096 elements.  It then writes the new
//       columns of its old rows into the tile, a (row, new dim) pair a
//       thread, and stores the tile's old rows.  A row block per candidate
//       dim (6 C of them; those of invalid candidates exit at once, those
//       that lost a dim after the map) writes its whole new row: the
//       loads of P's rows 0:7 it reads are issued before the map, and its
//       new columns come from a table of the 6 C values M(d, c)[j, i]
//       built beside the map.  No element is computed twice, and up to
//       N = 1024 none waits on a load issued after the map.
//
// EKF_MARK are the stage marks of tools/small_kernel_clocks.py (no code
// otherwise).

#include "common.cuh"

namespace {

// the camera's dims (r, q, v, w) before the first slot; a slot's dims
constexpr int CAM_DIM = 13, FEAT_DIM = 6;
constexpr int POSE = 7;                 // the dims J1 reads: r, q
constexpr int CAND = 32;                // candidates a chain CTA
constexpr int CHAIN_THREADS = 128;
// the compact operands of a candidate: G (2x4), B (6x7), D (6x6), padding
constexpr int OP_G = 0, OP_B = 8, OP_D = 50, OPS = 88;
constexpr int AUG_THREADS = 256;
constexpr int AUG_GROUPS = 4;           // groups of 4 elements a thread
constexpr int MAX_N = 12288;            // the largest N taken (a launch
                                        // also checks its shared memory)

// n floats from shared memory to global memory in 16-byte vectors (dst
// and src 16-byte aligned), the tail as floats; all as floats without VEC
// (a batched launch's later streams start off a 16-byte boundary when C
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

// g[0] p[0] + g[1] p[1] + g[2] p[2] + g[3] p[3] in the header's order
__device__ __forceinline__ float dot4(const float* g, float p0, float p1,
                                      float p2, float p3) {
    float s = __fmul_rn(g[0], p0);
    s = __fmaf_rn(g[1], p1, s);
    s = __fmaf_rn(g[2], p2, s);
    return __fmaf_rn(g[3], p3, s);
}

// Loads issued where they stand: volatile, so that the compiler neither
// sinks them to their first use (past a barrier) nor merges them.
__device__ __forceinline__ float4 ld_now4(const float* p) {
    float4 v;
    asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "l"(p));
    return v;
}
__device__ __forceinline__ float ld_now(const float* p) {
    float v;
    asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
    return v;
}
__device__ __forceinline__ int ld_now(const int* p) {
    int v;
    asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}
__device__ __forceinline__ int ld_now(const uint8_t* p) {
    int v;
    asm volatile("ld.global.nc.u8 %0, [%1];" : "=r"(v) : "l"(p));
    return v;
}

// (A)'s work on one stream (both entry points below run it).
template <bool VEC>
__device__ __forceinline__ void
init_chain_body(const float* __restrict__ cam7,
                const float* __restrict__ cand_uv,
                const float* __restrict__ P, float* __restrict__ feats,
                float* __restrict__ J1, float* __restrict__ J2,
                float* __restrict__ ops, int C, int N, float rho0, float r0,
                float r1, float r2, CamParams c) {
    __shared__ float sR[3][3];
    __shared__ float sP77[7][7];
    __shared__ __align__(16) float sF[CAND * 6];
    __shared__ __align__(16) float sJ1[CAND * 42];
    __shared__ __align__(16) float sJ2[CAND * 18];
    __shared__ __align__(16) float sO[CAND * OPS];
    const int t = threadIdx.x;
    const int c0 = blockIdx.x * CAND, nc = min(CAND, C - c0);
    const bool with_ops = P != nullptr;
    EKF_MARK(0, 0.0f);
    // the pose and the thread's candidate pixel, loaded before the
    // prologue's barrier
    float pose[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) pose[k] = ld_now(cam7 + k);
    const int ic = c0 + min(t, nc - 1);
    const float u = ld_now(cand_uv + 2 * ic), v = ld_now(cand_uv + 2 * ic + 1);
    const float qw = pose[3], qx = pose[4], qy = pose[5], qz = pose[6];
    // R(q) by 9 threads, P77 by the next 49
    if (t < 9) {
        const float w2 = qw * qw, x2 = qx * qx, y2 = qy * qy, z2 = qz * qz;
        float rv;
        switch (t) {
            case 0: rv = w2 + x2 - y2 - z2; break;
            case 1: rv = 2 * (qx * qy - qw * qz); break;
            case 2: rv = 2 * (qz * qx + qw * qy); break;
            case 3: rv = 2 * (qx * qy + qw * qz); break;
            case 4: rv = w2 - x2 + y2 - z2; break;
            case 5: rv = 2 * (qy * qz - qw * qx); break;
            case 6: rv = 2 * (qz * qx - qw * qy); break;
            case 7: rv = 2 * (qy * qz + qw * qx); break;
            default: rv = w2 - x2 - y2 + z2; break;
        }
        sR[t / 3][t % 3] = rv;
    } else if (with_ops && t < 9 + 49) {
        const int e = t - 9;
        sP77[e / 7][e % 7] = P[(long long)(e / 7) * N + e % 7];
    }
    __syncthreads();
    EKF_MARK(1, sR[2][2]);

    if (t < nc) {

        // one-shot undistort and its (u, v) Jacobian
        const float du = u - c.cx, dv = v - c.cy;
        const float mx = c.dx * du, my = c.dy * dv;
        const float r2s = mx * mx + my * my;
        const float d = 1.0f + c.k1 * r2s + c.k2 * r2s * r2s;
        const float g2 = 2.0f * (c.k1 + 2.0f * c.k2 * r2s);
        const float a = du * d / c.fx, b = dv * d / c.fy;   // unit-depth ray
        const float da_du = (d + du * g2 * mx * c.dx) / c.fx;
        const float da_dv = (du * g2 * my * c.dy) / c.fx;
        const float db_du = (dv * g2 * mx * c.dx) / c.fy;
        const float db_dv = (d + dv * g2 * my * c.dy) / c.fy;

        // world ray g = R(q) (a, b, 1)
        const float gx = sR[0][0] * a + sR[0][1] * b + sR[0][2];
        const float gy = sR[1][0] * a + sR[1][1] * b + sR[1][2];
        const float gz = sR[2][0] * a + sR[2][1] * b + sR[2][2];

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

        float* fo = sF + 6 * t;
        fo[0] = pose[0];
        fo[1] = pose[1];
        fo[2] = pose[2];
        fo[3] = atan2f(gx, gz);
        fo[4] = atan2f(-gy, h);
        fo[5] = rho0;

        float g[2][4];                  // J1 rows 3, 4 at columns 3..6
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            g[0][k] = dth_dgx * dg[k][0] + dth_dgz * dg[k][2];
            g[1][k] = dph_dgx * dg[k][0] + dph_dgy * dg[k][1]
                      + dph_dgz * dg[k][2];
        }
        float* j1 = sJ1 + 42 * t;       // (6, 7) row-major
        for (int e = 0; e < 42; ++e) j1[e] = 0.0f;
        j1[0 * 7 + 0] = 1.0f;
        j1[1 * 7 + 1] = 1.0f;
        j1[2 * 7 + 2] = 1.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            j1[3 * 7 + 3 + k] = g[0][k];
            j1[4 * 7 + 3 + k] = g[1][k];
        }

        // d(theta, phi)/d(u, v) through the ray
        const float dgx_du = sR[0][0] * da_du + sR[0][1] * db_du;
        const float dgx_dv = sR[0][0] * da_dv + sR[0][1] * db_dv;
        const float dgy_du = sR[1][0] * da_du + sR[1][1] * db_du;
        const float dgy_dv = sR[1][0] * da_dv + sR[1][1] * db_dv;
        const float dgz_du = sR[2][0] * da_du + sR[2][1] * db_du;
        const float dgz_dv = sR[2][0] * da_dv + sR[2][1] * db_dv;
        float j2r[2][2];                // J2 rows 3, 4 at columns 0, 1
        j2r[0][0] = dth_dgx * dgx_du + dth_dgz * dgz_du;
        j2r[0][1] = dth_dgx * dgx_dv + dth_dgz * dgz_dv;
        j2r[1][0] = dph_dgx * dgx_du + dph_dgy * dgy_du + dph_dgz * dgz_du;
        j2r[1][1] = dph_dgx * dgx_dv + dph_dgy * dgy_dv + dph_dgz * dgz_dv;
        float* j2 = sJ2 + 18 * t;       // (6, 3) row-major
        for (int e = 0; e < 18; ++e) j2[e] = 0.0f;
        j2[3 * 3 + 0] = j2r[0][0];
        j2[3 * 3 + 1] = j2r[0][1];
        j2[4 * 3 + 0] = j2r[1][0];
        j2[4 * 3 + 1] = j2r[1][1];
        j2[5 * 3 + 2] = 1.0f;

        if (with_ops) {
            float* o = sO + OPS * t;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                o[OP_G + k] = g[0][k];
                o[OP_G + 4 + k] = g[1][k];
            }
            // B = J1 P77: rows 0:3 select P77's, rows 3:5 by G, row 5 zero
            float B[6][7];
#pragma unroll
            for (int k = 0; k < 7; ++k) {
                for (int r = 0; r < 3; ++r) B[r][k] = sP77[r][k];
                for (int r = 0; r < 2; ++r)
                    B[3 + r][k] = dot4(g[r], sP77[3][k], sP77[4][k],
                                       sP77[5][k], sP77[6][k]);
                B[5][k] = 0.0f;
            }
            // D = B J1^T + J2 diag(r_add) J2^T
            const float rr[2] = {r0, r1};
#pragma unroll
            for (int r = 0; r < 6; ++r) {
#pragma unroll
                for (int k = 0; k < 7; ++k) o[OP_B + 7 * r + k] = B[r][k];
#pragma unroll
                for (int j = 0; j < 6; ++j) {
                    float bj;
                    if (j < 3) bj = B[r][j];
                    else if (j < 5)
                        bj = dot4(g[j - 3], B[r][3], B[r][4], B[r][5],
                                  B[r][6]);
                    else bj = 0.0f;
                    float noise = 0.0f;
                    if (r >= 3 && r < 5 && j >= 3 && j < 5)
                        noise = __fadd_rn(
                            __fmul_rn(__fmul_rn(j2r[r - 3][0], rr[0]),
                                      j2r[j - 3][0]),
                            __fmul_rn(__fmul_rn(j2r[r - 3][1], rr[1]),
                                      j2r[j - 3][1]));
                    else if (r == 5 && j == 5)
                        noise = r2;
                    o[OP_D + 6 * r + j] = __fadd_rn(bj, noise);
                }
            }
            o[OPS - 2] = 0.0f;
            o[OPS - 1] = 0.0f;
        }
    }
    __syncthreads();
    EKF_MARK(2, 0.0f);
    copy_out<VEC>(feats + 6 * (long long)c0, sF, 6 * nc);
    copy_out<VEC>(J1 + 42 * (long long)c0, sJ1, 42 * nc);
    copy_out<VEC>(J2 + 18 * (long long)c0, sJ2, 18 * nc);
    if (with_ops) copy_out<VEC>(ops + OPS * (long long)c0, sO, OPS * nc);
    EKF_MARK(3, 0.0f);
}

__global__ void __launch_bounds__(CHAIN_THREADS)
init_chain(const float* __restrict__ cam7, const float* __restrict__ cand_uv,
           const float* __restrict__ P, float* __restrict__ feats,
           float* __restrict__ J1, float* __restrict__ J2,
           float* __restrict__ ops, int C, int N, float rho0, float r0,
           float r1, float r2, CamParams c) {
    init_chain_body<true>(cam7, cand_uv, P, feats, J1, J2, ops, C, N, rho0,
                          r0, r1, r2, c);
}

// B streams stacked: blockIdx.y is the stream, whose CTAs run exactly the
// single-stream chain on its own candidates (its outputs' 16-byte vectors
// only where every stream's start is aligned, VEC: C even).
template <bool VEC>
__global__ void __launch_bounds__(CHAIN_THREADS)
init_chain_batched(const float* __restrict__ cam7,
                   const float* __restrict__ cand_uv,
                   const float* __restrict__ P, float* __restrict__ feats,
                   float* __restrict__ J1, float* __restrict__ J2,
                   float* __restrict__ ops, int C, int N, float rho0,
                   float r0, float r1, float r2, CamParams c) {
    const long long s = blockIdx.y, sC = s * C;
    init_chain_body<VEC>(cam7 + 7 * s, cand_uv + 2 * sC,
                         P != nullptr ? P + s * N * N : nullptr,
                         feats + 6 * sC, J1 + 42 * sC, J2 + 18 * sC,
                         ops != nullptr ? ops + OPS * sC : nullptr, C, N,
                         rho0, r0, r1, r2, c);
}

// 6 c + row at candidate c's dims of the map, if c is valid (atomicMax:
// the higher candidate wins), and each dim appended to ``list`` (count in
// list[0]; a dim two candidates name is appended twice) when it is given
__device__ __forceinline__ void place(int* map, int* list, int okc, int slot,
                                      int c, int N) {
    if (!okc) return;
    const long long base = CAM_DIM + (long long)FEAT_DIM * slot;
    for (int k = 0; k < FEAT_DIM; ++k)
        if (base + k >= 0 && base + k < N) {
            atomicMax(&map[base + k], FEAT_DIM * c + k);
            if (list != nullptr)
                list[1 + atomicAdd(&list[0], 1)] = (int)base + k;
        }
}

// map[0..N) = -1, then 6 c + row at each valid candidate's dims (and the
// list of them, when given); two block barriers.  A thread's first
// candidate's flag and slot are loaded before the map is set; ``between``
// runs after the initialization, before the first barrier, ``after``
// after the placement, before the second.
template <class Between, class After>
__device__ __forceinline__ void build_map(int* map, int* list,
                                          const int* __restrict__ slots,
                                          const uint8_t* __restrict__ ok,
                                          int N, int C, Between between,
                                          After after) {
    const int c0 = threadIdx.x;
    const int ok0 = c0 < C ? ld_now(ok + c0) : 0;
    const int s0 = c0 < C ? ld_now(slots + c0) : 0;
    for (int k = threadIdx.x; k < N; k += AUG_THREADS) map[k] = -1;
    if (list != nullptr && threadIdx.x == 0) list[0] = 0;
    between();
    __syncthreads();
    place(map, list, ok0, s0, c0, N);
    for (int c = c0 + AUG_THREADS; c < C; c += AUG_THREADS)
        place(map, list, ok[c], slots[c], c, N);
    after();
    __syncthreads();
}

// A copy block: 4096 consecutive elements of P, groups of 4 a thread
// (AUG_GROUPS of them), loaded first and staged in a shared-memory tile.
// Elements of new rows are left to the row blocks; the new columns of the
// old rows, (J1_d P[:7, :])[j, r] for a column of (d, j), are written into
// the tile as (row, new dim) pairs spread over the threads, from G and
// P[:7, r] staged in shared memory; then the tile's old rows are stored.
template <bool VEC>
__device__ void augment_copy(const float* __restrict__ P,
                             const float* __restrict__ ops,
                             const int* __restrict__ slots,
                             const uint8_t* __restrict__ ok,
                             float* __restrict__ out, int N, int C,
                             int* smem) {
    constexpr int TILE = 4 * AUG_THREADS * AUG_GROUPS;
    // N <= MAX_N: every element index fits an int
    const int total = N * N;
    const int e_lo = blockIdx.x * TILE;
    const int e_hi = min(total, e_lo + TILE);
    const int r_lo = e_lo / N;
    const int rows = (e_hi - 1) / N - r_lo + 1;
    float* tile = reinterpret_cast<float*>(smem);       // TILE
    int* map = smem + TILE;                             // N
    int* list = map + N;                                // 1 + 6 C
    float* sG = reinterpret_cast<float*>(list + 1 + FEAT_DIM * C);  // 8 C
    float* sPc = sG + 8 * C;                            // (rows, 7)
    const int g0 = blockIdx.x * AUG_THREADS * AUG_GROUPS + threadIdx.x;
    EKF_MARK(0, 0.0f);
    float v[AUG_GROUPS][4];
#pragma unroll
    for (int u = 0; u < AUG_GROUPS; ++u) {
        const int e = 4 * (g0 + u * AUG_THREADS);
        if (VEC) {
            if (e < total) {
                const float4 q = ld_now4(P + e);
                v[u][0] = q.x;
                v[u][1] = q.y;
                v[u][2] = q.z;
                v[u][3] = q.w;
            }
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (e + k < total) v[u][k] = ld_now(P + e + k);
        }
    }
    // the first round of G and of P[:7, rows], loaded up front too
    constexpr int GREG = 8;            // G floats a thread (C <= 256)
    float gl[GREG];
#pragma unroll
    for (int q = 0; q < GREG; ++q) {
        const int e = min((int)threadIdx.x + q * AUG_THREADS, 8 * C - 1);
        gl[q] = ld_now(ops + OPS * (e / 8) + OP_G + e % 8);
    }
    const int ep = min((int)threadIdx.x, 7 * rows - 1);
    const float pcl = ld_now(P + (ep % 7) * N + r_lo + ep / 7);
    // the tile and the staged operands are written after the placement,
    // so that their loads' latency overlaps the map's first barrier
    build_map(map, list, slots, ok, N, C, [] {}, [&] {
#pragma unroll
        for (int q = 0; q < GREG; ++q) {
            const int e = threadIdx.x + q * AUG_THREADS;
            if (e < 8 * C) sG[e] = gl[q];
        }
        for (int e = threadIdx.x + GREG * AUG_THREADS; e < 8 * C;
             e += AUG_THREADS)
            sG[e] = ops[OPS * (e / 8) + OP_G + e % 8];
        if ((int)threadIdx.x < 7 * rows) sPc[threadIdx.x] = pcl;
        for (int e = threadIdx.x + AUG_THREADS; e < 7 * rows;
             e += AUG_THREADS)
            sPc[e] = P[(e % 7) * N + r_lo + e / 7];
#pragma unroll
        for (int u = 0; u < AUG_GROUPS; ++u) {
            const int o = 4 * (threadIdx.x + u * AUG_THREADS);
            if (VEC) {
                if (e_lo + o < total)
                    *reinterpret_cast<float4*>(tile + o) = make_float4(
                        v[u][0], v[u][1], v[u][2], v[u][3]);
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    if (e_lo + o + k < total) tile[o + k] = v[u][k];
            }
        }
    });
    EKF_MARK(1, 0.0f);
    const int count = list[0];
    for (int p = threadIdx.x; p < rows * count; p += AUG_THREADS) {
        const int rr = p / count, dim = list[1 + p % count];
        const int r = r_lo + rr, e = r * N + dim;
        if (e < e_lo || e >= e_hi || map[r] >= 0) continue;
        const int mn = map[dim];
        const int d = mn / FEAT_DIM, j = mn % FEAT_DIM;
        const float* pc = sPc + 7 * rr;
        tile[e - e_lo] = j < 3 ? pc[j]
                         : j == 5 ? 0.0f
                         : dot4(sG + 8 * d + 4 * (j - 3), pc[3], pc[4],
                                pc[5], pc[6]);
    }
    __syncthreads();
    EKF_MARK(2, 0.0f);
#pragma unroll
    for (int u = 0; u < AUG_GROUPS; ++u) {
        const int o = 4 * (threadIdx.x + u * AUG_THREADS), e = e_lo + o;
        if (VEC) {
            if (e < total && map[e / N] < 0)
                *reinterpret_cast<float4*>(out + e) =
                    *reinterpret_cast<const float4*>(tile + o);
        } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (e + k < total && map[(e + k) / N] < 0)
                    out[e + k] = tile[o + k];
        }
    }
    EKF_MARK(3, 0.0f);
}

// V[t] = M(d, c)[j, i] for t = 6 d + j from its six loads tb (D_d[j][i],
// B_d[j][min(i, 2)], B_d[j][3..6]) and the row's G row g
__device__ __forceinline__ float table_value(const float* tb, int t, int c,
                                             int i, const float* g) {
    if (t / FEAT_DIM == c) return tb[0];
    if (i < 3) return tb[1];
    if (i == 5) return 0.0f;
    return dot4(g, tb[2], tb[3], tb[4], tb[5]);
}

__device__ __forceinline__ void table_loads(const float* __restrict__ ops,
                                            int t, int i, float* tb) {
    const int d = t / FEAT_DIM, j = t % FEAT_DIM;
    const float* b = ops + OPS * d + OP_B + 7 * j;
    tb[0] = ld_now(ops + OPS * d + OP_D + 6 * j + i);
    tb[1] = ld_now(b + min(i, 2));
    for (int k = 0; k < 4; ++k) tb[2 + k] = ld_now(b + 3 + k);
}

template <bool VEC>
__device__ void augment_row(const float* __restrict__ P,
                            const float* __restrict__ ops,
                            const int* __restrict__ slots,
                            const uint8_t* __restrict__ ok,
                            float* __restrict__ out, int N, int C, int m,
                            int* smem) {
    constexpr int TBL = 4;          // table entries a thread loads up front
    const int c = m / FEAT_DIM, i = m % FEAT_DIM;
    const int groups = (N + 3) / 4;
    EKF_MARK(0, 0.0f);
    // every load that does not need the map, issued first: the flag and
    // slot, G, the first group's columns of the P rows the new row reads
    // (row i, or rows 3..6), the first TBL table entries' operands
    const bool valid = ld_now(ok + c) != 0;
    const int slot = ld_now(slots + c);
    const float* gc = ops + OPS * c + OP_G + 4 * max(i - 3, 0);
    const float g[4] = {ld_now(gc), ld_now(gc + 1), ld_now(gc + 2),
                        ld_now(gc + 3)};
    const int k0 = i < 3 ? i : 3, nk = i < 3 ? 1 : (i == 5 ? 0 : 4);
    float p[4][4];
    auto load = [&](int grp) {
        const int n0 = 4 * grp;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            if (k >= nk) break;
            const float* row = P + (k0 + k) * N + n0;
            if (VEC) {
                const float4 q = ld_now4(row);
                p[k][0] = q.x;
                p[k][1] = q.y;
                p[k][2] = q.z;
                p[k][3] = q.w;
            } else {
#pragma unroll
                for (int t = 0; t < 4; ++t)
                    p[k][t] = n0 + t < N ? ld_now(row + t) : 0.0f;
            }
        }
    };
    if ((int)threadIdx.x < groups) load(threadIdx.x);
    float tb[TBL][6];
#pragma unroll
    for (int q = 0; q < TBL; ++q)
        table_loads(ops, min((int)threadIdx.x + q * AUG_THREADS,
                             FEAT_DIM * C - 1), i, tb[q]);
    const long long dim = CAM_DIM + (long long)FEAT_DIM * slot + i;
    if (!valid || dim < 0 || dim >= N) return;      // uniform over the block
    int* map = smem;
    float* V = reinterpret_cast<float*>(map + N);   // (6 C)
    build_map(map, nullptr, slots, ok, N, C, [&] {
#pragma unroll
        for (int q = 0; q < TBL; ++q) {
            const int t = threadIdx.x + q * AUG_THREADS;
            if (t < FEAT_DIM * C) V[t] = table_value(tb[q], t, c, i, g);
        }
        for (int t = threadIdx.x + TBL * AUG_THREADS; t < FEAT_DIM * C;
             t += AUG_THREADS) {
            float tt[6];
            table_loads(ops, t, i, tt);
            V[t] = table_value(tt, t, c, i, g);
        }
    }, [] {});
    if (map[dim] != m) return;                      // a higher candidate won
    EKF_MARK(1, p[0][0]);
    float* orow = out + dim * N;
    for (int grp = threadIdx.x; grp < groups; grp += AUG_THREADS) {
        if (grp != (int)threadIdx.x) load(grp);
        float o[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const int n = 4 * grp + t;
            const int mn = n < N ? map[n] : -1;
            if (mn >= 0) o[t] = V[mn];
            else if (i < 3) o[t] = p[0][t];
            else if (i == 5) o[t] = 0.0f;
            else o[t] = dot4(g, p[0][t], p[1][t], p[2][t], p[3][t]);
        }
        if (VEC) {
            *reinterpret_cast<float4*>(orow + 4 * grp) =
                make_float4(o[0], o[1], o[2], o[3]);
        } else {
#pragma unroll
            for (int t = 0; t < 4; ++t)
                if (4 * grp + t < N) orow[4 * grp + t] = o[t];
        }
    }
    EKF_MARK(2, 0.0f);
}

// The grid: copy_blocks copy blocks, then a row block for each of the 6 C
// candidate dims.
template <bool VEC>
__global__ void __launch_bounds__(AUG_THREADS)
init_augment(const float* __restrict__ P, const float* __restrict__ ops,
             const int* __restrict__ slots, const uint8_t* __restrict__ ok,
             float* __restrict__ out, int N, int C, int copy_blocks) {
    extern __shared__ int smem[];
    if ((int)blockIdx.x < copy_blocks)
        augment_copy<VEC>(P, ops, slots, ok, out, N, C, smem);
    else
        augment_row<VEC>(P, ops, slots, ok, out, N, C,
                         blockIdx.x - copy_blocks, smem);
}

// B streams stacked: blockIdx.y is the stream, whose blocks run exactly
// the single-stream roles on its own P, operands and slots.
template <bool VEC>
__global__ void __launch_bounds__(AUG_THREADS)
init_augment_batched(const float* __restrict__ P,
                     const float* __restrict__ ops,
                     const int* __restrict__ slots,
                     const uint8_t* __restrict__ ok, float* __restrict__ out,
                     int N, int C, int copy_blocks) {
    extern __shared__ int smem[];
    const long long s = blockIdx.y, sP = s * N * N, sC = s * C;
    if ((int)blockIdx.x < copy_blocks)
        augment_copy<VEC>(P + sP, ops + OPS * sC, slots + sC, ok + sC,
                          out + sP, N, C, smem);
    else
        augment_row<VEC>(P + sP, ops + OPS * sC, slots + sC, ok + sC,
                         out + sP, N, C, blockIdx.x - copy_blocks, smem);
}

}  // namespace

// feats (C, 6), J1 (C, 6, 7), J2 (C, 6, 3) for C >= 1 candidates; with P
// (N, N) given, also ops (C, 88), the compact operands of
// ekf_init_augment (P null: ops is not written).  Returns the launch's
// cudaError_t, or 0.
// B streams stacked (B > 1) take one launch of init_chain_batched.
EKF_EXPORT int ekf_init_batched(const float* cam7, const float* cand_uv,
                                const float* P, float* feats, float* J1,
                                float* J2, float* ops, int C, int N, int B,
                                float rho0, float r0, float r1, float r2,
                                const CamParams* cam, void* stream) {
    if (C < 1 || (P != nullptr && N < POSE) || B < 1 || B > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int ctas = (C + CAND - 1) / CAND;
    if (B > 1 && C % 2 == 0)
        init_chain_batched<true><<<dim3(ctas, B), CHAIN_THREADS, 0, st>>>(
            cam7, cand_uv, P, feats, J1, J2, ops, C, N, rho0, r0, r1, r2,
            *cam);
    else if (B > 1)
        init_chain_batched<false><<<dim3(ctas, B), CHAIN_THREADS, 0, st>>>(
            cam7, cand_uv, P, feats, J1, J2, ops, C, N, rho0, r0, r1, r2,
            *cam);
    else
        init_chain<<<ctas, CHAIN_THREADS, 0, st>>>(
            cam7, cand_uv, P, feats, J1, J2, ops, C, N, rho0, r0, r1, r2,
            *cam);
    return ekf_last_error();
}

// One stream (tools/small_kernel_clocks.py calls this entry).
EKF_EXPORT int ekf_init(const float* cam7, const float* cand_uv,
                        const float* P, float* feats, float* J1, float* J2,
                        float* ops, int C, int N, float rho0, float r0,
                        float r1, float r2, const CamParams* cam,
                        void* stream) {
    return ekf_init_batched(cam7, cand_uv, P, feats, J1, J2, ops, C, N, 1,
                            rho0, r0, r1, r2, cam, stream);
}

// out (N, N) = P with the C candidates' rows and columns placed (slots
// int32, ok one byte each, ops from ekf_init).  Returns the launch's
// cudaError_t, or 0.
// B streams stacked (B > 1) take one launch of init_augment_batched.
EKF_EXPORT int ekf_init_augment_batched(const float* P, const float* ops,
                                        const int* slots, const uint8_t* ok,
                                        float* out, int N, int C, int B,
                                        void* stream) {
    if (N < CAM_DIM || N > MAX_N || C < 1 || B < 1 || B > 65535)
        return (int)cudaErrorInvalidValue;
    const long long per_block = 4LL * AUG_THREADS * AUG_GROUPS;
    const int copy_blocks = (int)(((long long)N * N + per_block - 1)
                                  / per_block);
    // a copy block's tile, map, dim list, G and P[:7, rows] (more than a
    // row block's map and table)
    const int rows = (int)((per_block - 1) / N) + 2;
    const size_t smem = 4 * ((size_t)per_block + N + 1 + FEAT_DIM * C
                             + 8 * (size_t)C + 7 * (size_t)rows);
    // the first call raises the dynamic shared memory limit to the
    // device's; later calls (possibly inside a CUDA graph capture) only
    // launch
    static int optin = 0;
    int err = 0;
    if (optin == 0) {
        int device = 0, value = 0;
        if ((err = (int)cudaGetDevice(&device))) return err;
        if ((err = (int)cudaDeviceGetAttribute(
                 &value, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)))
            return err;
        for (const void* fn : {(const void*)init_augment<true>,
                               (const void*)init_augment<false>,
                               (const void*)init_augment_batched<true>,
                               (const void*)init_augment_batched<false>})
            if ((err = (int)cudaFuncSetAttribute(
                     fn, cudaFuncAttributeMaxDynamicSharedMemorySize, value)))
                return err;
        optin = value;
    }
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    const bool vec = N % 4 == 0 && ((uintptr_t)P & 15) == 0
                     && ((uintptr_t)out & 15) == 0;
    const int blocks = copy_blocks + FEAT_DIM * C;
    cudaStream_t st = (cudaStream_t)stream;
    if (B > 1 && vec)
        init_augment_batched<true><<<dim3(blocks, B), AUG_THREADS, smem,
                                     st>>>(P, ops, slots, ok, out, N, C,
                                           copy_blocks);
    else if (B > 1)
        init_augment_batched<false><<<dim3(blocks, B), AUG_THREADS, smem,
                                      st>>>(P, ops, slots, ok, out, N, C,
                                            copy_blocks);
    else if (vec)
        init_augment<true><<<blocks, AUG_THREADS, smem, st>>>(
            P, ops, slots, ok, out, N, C, copy_blocks);
    else
        init_augment<false><<<blocks, AUG_THREADS, smem, st>>>(
            P, ops, slots, ok, out, N, C, copy_blocks);
    return ekf_last_error();
}

// One stream (tools/small_kernel_clocks.py calls this entry).
EKF_EXPORT int ekf_init_augment(const float* P, const float* ops,
                                const int* slots, const uint8_t* ok,
                                float* out, int N, int C, void* stream) {
    return ekf_init_augment_batched(P, ops, slots, ok, out, N, C, 1, stream);
}
