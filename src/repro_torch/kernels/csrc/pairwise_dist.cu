// Pairwise dissimilarity matrix R[i, j] = dissim(X[i], Y[j]), CUDA C++ for
// sm_90a.
//
// Replaces: src/repro/kernels/pairwise_dist.py::pairwise_dist_pallas (the
// TPU kernel, tile math in _tile_dissim), and with repro_pairwise_dist_batch
// pairwise_dist_pallas_batch (:179, its (b, n/BM, n/BN) grid of per-lane
// self-matrices).  Same four metrics and two forms:
//   gram   euclidean / sqeuclidean  max(|x|^2 + |y|^2 - 2 x.y, 0) (sqrt)
//          cosine                   clip(1 - x.y / max(|x||y|, 1e-12), 0, 2)
//   direct euclidean / sqeuclidean  sum_k (x_k - y_k)^2            (sqrt)
//          manhattan                sum_k |x_k - y_k|
//
// What bounds it on the H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor
// cores; each input read once, R written once; a self-matrix needs the dot
// products of one triangle, n (n + 1) / 2 pairs, as R[i, j] == R[j, i]):
//   self (2,048, 64), the vat fit's matrix: 16 MiB out, 5.0 us, against
//     0.27 GFLOP, 4.0 us: bytes, 5.16 us;
//   a flashvat seed-scan block (2,000 x 7,143, 64; 175 of them a fit at
//     n = 50,000): 1.89 GFLOP, 28.2 us, against 59.5 MB, 17.8 us:
//     operations, 28.2 us;
//   self (16,384, 32), the ivat fit at its top: 1 GiB out, 0.321 ms: bytes;
//   the batch (8, 2,048, 64) of fit_many: 134 MB out, 41.3 us: bytes.
// TF32 tensor cores are ruled out: numerics/condition.py derives KAPPA_SAFE
// from the f32 epsilon, and a 10-bit mantissa in the cross term would void
// that derivation.
//
// Design:
//   * one triangle of tiles for a self-matrix (Y is X, and every lane of the
//     batch): the grid enumerates the T (T + 1) / 2 square tiles (I, J) with
//     I <= J, decoded from the linear block index in closed form.  A tile
//     off the diagonal writes its block and its mirror, block (J, I), from
//     the same registers; a diagonal tile writes its whole block.
//     Mirroring changes no bit: every operation of dissim.cuh is symmetric
//     in the pair.  A rectangular call (Y given) runs the full grid of
//     tiles on the same engine;
//   * a pre-pass, one launch over the rows of X (all b lanes) and of Y:
//     each row's norm by warp_row_norm (gram kinds and cosine), and a
//     feature-major f32 copy of the rows (feature k of row r at k ld + r, ld
//     the row count rounded up to 4, the padding rows zero), written 32
//     contiguous bytes a feature through shared memory.  bf16 storage is
//     converted there (exactly), so the tiles read f32 and a bf16 matrix
//     has the bits of the f32 one of the same values;
//   * the tile engine (after knn_graph.cu's): BT x BT tiles, an 8 x 8 block
//     of f32 accumulators a thread, features staged BK at a time (BK chosen
//     by d before launch: 8 for d <= 8, 16 for d <= 16, 32 above) into two
//     buffers filled by 16-byte cp.async (cp_async.cuh), the next chunk in
//     flight while one is multiplied.  Staging is feature-major, as the
//     copy is: a thread's eight rows are two float4 of one feature and its
//     eight columns two more, so 4 shared loads feed 64 FMAs and operands
//     and accumulators take 80 registers; the feature loop is unrolled by
//     4 (10-12 % faster than by 2 at d = 64, slower by 8, on an H100).  (Point-major staging, as the kNN
//     kernel's, needs 8 float4 of rows per 4 features and spilled under the
//     128-register cap of two CTAs an SM; transposing in the copies took
//     4-byte cp.async, 4x the copies, a third of the FMA loop's time:
//     tools/pairwise_phases.py on an H100.)  A quarter-warp's copies cover
//     128 contiguous bytes and its float4 reads 64 or 16: no bank conflict,
//     and the loop's shared addresses are immediates off two pointers.  The
//     tile's row and column norms ride with the first chunk into shared
//     memory.  Out-of-range rows and features are zero-filled, the identity
//     of every accumulation;
//   * a thread owns rows 4 ty + u and BT / 2 + 4 ty + u, columns 4 tx + v
//     and BT / 2 + 4 tx + v (u, v < 4), so its results leave as float4 both
//     ways: four columns of a row of block (I, J), and four rows of a
//     column, which are four contiguous entries of a row of the mirror (a
//     warp of 4 tx by 8 ty writes 64 contiguous bytes of each of 8 rows of
//     the block, 128 of each of 4 rows of the mirror).  Where rows are not a
//     multiple of 4 floats, the block and the mirror go through a copy of
//     the tile in shared memory instead and each warp writes whole rows;
//   * the tile side by the launch's tile count: BT = 128 (256 threads, two
//     CTAs an SM) when there are at least BIG_TILE_MIN tiles of 128 (about
//     two waves of two CTAs on 132 SMs), else BT = 64 (64 threads, several
//     CTAs an SM), which spreads the vat fit's 2,048 matrix (136 tiles of
//     128) over 528 tiles, four an SM, instead of 4 SMs taking two;
//   * two launches a call, the pre-pass and the tiles; a self-matrix's
//     diagonal is written as exactly 0 in the tiles' epilogue when asked
//     (zero_diag: ops.pairwise_dist, and every lane of the batch);
//   * stores: evict-first (st.global.cs) when the launch writes at least
//     STREAM_MIN_BYTES (32 MiB), default write-back below.  The vat fit's
//     16 MiB matrix fits in the 50 MB L2 and vat_prim_order reads it next:
//     streaming stores there made that kernel 17-19 % slower.  The 57 MB
//     seed blocks, the 134 MB batch and the 1 GiB ivat matrix do not fit;
//     streaming stores wrote the last two 2-5 % faster, the seed block
//     within the spread (tools/pairwise_times.py --variants on an H100;
//     PERF.md);
//   * what remains (tools/pairwise_phases.py on an H100): the FMA loop
//     runs at about 92 % of the FMA issue rate; the finish and stores come
//     after it, in both CTAs of an SM at once (a copy that stores nothing
//     saves 0-17 %), then the staging and the last wave's tail.  Persistent
//     CTAs, and two thread groups a CTA half a tile apart, were both
//     measured slower and removed;
//   * the bits: every entry is one fmaf chain from 0.0f over features
//     0..d-1 in ascending order (accumulate<KIND>), then finish<KIND> with
//     the norms of warp_row_norm (dissim.cuh), whichever tile, thread or
//     mirror computes it: so R[i, j] == R[j, i], a matrix-free Prim row
//     (pair_dissim) equals the matrix's row, and the kNN kernel's lists
//     equal its sorted rows, bit for bit.  No split-K, no reassociation.
//
// The batch ("slab of one", as the TPU kernel's batch grid): lane z of a
// (b, n, d) stack is blockIdx.y, and every operand of the tile kernel sits at
// that lane's stride, so a lane runs exactly the single matrix's code and
// its matrix equals the single call on that lane bit for bit.  The pre-pass
// runs over all b n rows in one launch (row-wise, so the same bits per
// row).  gridDim.y caps a batch at 65,535 lanes; the wrapper raises above
// it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "cp_async.cuh"
#include "dissim.cuh"

// Launch-wide thresholds; tools/pairwise_times.py builds copies of this file
// with each overridden to time the other side.
#ifndef PAIRWISE_STREAM_MIN_BYTES
#define PAIRWISE_STREAM_MIN_BYTES (32ll << 20)
#endif
#ifndef PAIRWISE_BIG_TILE_MIN
#define PAIRWISE_BIG_TILE_MIN 512
#endif

namespace {

using namespace repro_torch;  // Kind, to_f32, accumulate, finish,
                              // warp_row_norm, cp_async

constexpr int TM = 8;         // accumulator rows per thread
constexpr int TN = 8;         // accumulator columns per thread
constexpr int PRE_ROWS = 8;   // rows of a pre-pass block, one a warp
constexpr int PRE_K = 128;    // features a pre-pass block transposes a pass
constexpr long long STREAM_MIN_BYTES = PAIRWISE_STREAM_MIN_BYTES;
constexpr long long BIG_TILE_MIN = PAIRWISE_BIG_TILE_MIN;

__host__ __device__ constexpr int threads_of(int bt) {
    return (bt / TM) * (bt / TN);
}
// Two staging buffers (BK features of BT X rows, then of BT Y rows), or a
// BT x BT copy of the finished tile, whichever is larger; then the tile's
// BT row norms and BT column norms.
__host__ __device__ constexpr size_t smem_bytes(int bt, int bk) {
    return sizeof(float) * ((4 * bk * bt > bt * bt ? 4 * bk * bt : bt * bt)
                            + 2 * bt);
}
static_assert(smem_bytes(128, 32) <= 232448 / 2, "two CTAs an SM");

__host__ __device__ constexpr long long round4(long long v) {
    return (v + 3) & ~3ll;
}

long long tile_count(int bt, int n, int m, int tri) {
    const long long tn = (n + bt - 1) / bt;
    const long long tm = (m + bt - 1) / bt;
    return tri ? tn * (tn + 1) / 2 : tn * tm;
}

// The f32 scratch of a call: the row norms (b n of X, then m of Y unless
// Y is X), then the feature-major copies, lane z of X at z d ldn (feature k
// of row r at k ldn + r, ldn = n rounded up to 4, the rows past n zero),
// then Y's at d ldm.
struct Scratch {
    float* norms_x;
    float* norms_y;
    float* xt;
    float* yt;
    long long ldn, ldm, words;
};

Scratch layout(float* base, int b, int n, int m, int d, int y_is_x) {
    Scratch s{};
    s.ldn = round4(n);
    s.ldm = y_is_x ? s.ldn : round4(m);
    const long long nnorm = round4(static_cast<long long>(b) * n
                                   + (y_is_x ? 0 : m));
    const long long nx = static_cast<long long>(b) * d * s.ldn;
    s.words = nnorm + nx + (y_is_x ? 0 : static_cast<long long>(d) * s.ldm);
    if (base != nullptr) {
        s.norms_x = base;
        s.norms_y = y_is_x ? base : base + static_cast<long long>(b) * n;
        s.xt = base + nnorm;
        s.yt = y_is_x ? s.xt : s.xt + nx;
    }
    return s;
}

// The pre-pass, blocks of PRE_ROWS rows, one warp a row: the first
// b ceil(n / PRE_ROWS) blocks take lane z's rows of X, the rest (Y not null)
// the rows of Y.  Each row's norm by warp_row_norm (take = 1: sum_k x_k^2,
// 2: its sqrt, 0: none) and, when xt is not null, its f32 values into the
// feature-major copy, through shared memory so that a block writes 32
// contiguous bytes a feature.  The copy's padding rows (n .. ldn - 1) are
// written as zeros.
template <typename T>
__global__ void __launch_bounds__(32 * PRE_ROWS)
prepass_kernel(const T* __restrict__ X, const T* __restrict__ Y, int b,
               int n, int m, int d, int take, float* __restrict__ norms_x,
               float* __restrict__ norms_y, float* __restrict__ xt,
               float* __restrict__ yt, long long ldn, long long ldm) {
    __shared__ float rows[PRE_ROWS][PRE_K + 1];
    const long long xblocks = (n + PRE_ROWS - 1) / PRE_ROWS;
    const long long blk = blockIdx.x;
    const T* src;
    float* nrm;
    float* dst;
    int count, r0;
    long long ld;
    if (blk < b * xblocks) {
        const long long z = blk / xblocks;
        r0 = static_cast<int>(blk % xblocks) * PRE_ROWS;
        src = X + z * n * d;
        nrm = norms_x + z * n;
        dst = xt != nullptr ? xt + z * d * ldn : nullptr;
        count = n;
        ld = ldn;
    } else {
        r0 = static_cast<int>(blk - b * xblocks) * PRE_ROWS;
        src = Y;
        nrm = norms_y;
        dst = yt;
        count = m;
        ld = ldm;
    }
    const int w = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int r = r0 + w;
    if (take != 0 && r < count) {
        const float s = warp_row_norm(src + static_cast<size_t>(r) * d, d,
                                      lane, take == 2);
        if (lane == 0) nrm[r] = s;
    }
    if (dst == nullptr) return;   // block-uniform
    for (int k0 = 0; k0 < d; k0 += PRE_K) {
        const int kn = min(PRE_K, d - k0);
        for (int k = lane; k < kn; k += 32)
            rows[w][k] = r < count
                ? to_f32(src[static_cast<size_t>(r) * d + k0 + k]) : 0.0f;
        __syncthreads();
        for (int e = threadIdx.x; e < PRE_ROWS * kn; e += 32 * PRE_ROWS) {
            const int rr = e % PRE_ROWS;
            const int k = e / PRE_ROWS;
            if (r0 + rr < ld)
                dst[(k0 + k) * ld + r0 + rr] = rows[rr][k];
        }
        __syncthreads();
    }
}

__device__ __forceinline__ void put(float* p, float v, bool stream) {
    if (stream) __stcs(p, v);
    else *p = v;
}
__device__ __forceinline__ void put4(float* p, float4 v, bool stream) {
    if (stream) __stcs(reinterpret_cast<float4*>(p), v);
    else *reinterpret_cast<float4*>(p) = v;
}

// Rows [row0, row0 + BT) x features [k0, k0 + BK) from a feature-major copy
// (leading dimension ld) into a feature-major staging buffer (feature k's
// BT rows at k BT) by 16-byte cp.async, four rows a copy: consecutive
// threads take consecutive groups of one feature, so a warp reads 512
// (BT = 128) or twice 256 (BT = 64) contiguous bytes, and a quarter-warp's
// copies cover 128 contiguous bytes of shared memory (no bank conflict).
// Groups past ld and features past d are zero-filled.
template <int BK, int BT, int THREADS>
__device__ __forceinline__ void stage(float* buf, const float* xt,
                                      long long ld, int d, int row0,
                                      int k0) {
    constexpr int GROUPS = BT / 4;
    constexpr int COPIES = BK * GROUPS / THREADS;
    static_assert(COPIES * THREADS == BK * GROUPS, "whole passes");
#pragma unroll
    for (int it = 0; it < COPIES; ++it) {
        const int e = threadIdx.x + it * THREADS;
        const int g = e % GROUPS;
        const int k = e / GROUPS;
        const bool ok = k0 + k < d && row0 + 4 * g < ld;
        cp_async<16>(buf + k * BT + 4 * g,
                     ok ? xt + (k0 + k) * ld + row0 + 4 * g : xt,
                     ok ? 16 : 0);
    }
}

// One BT x BT tile of lane blockIdx.y: (I, J) from blockIdx.x, the upper
// triangle's I <= J when tri (then Y is X and m == n), the full grid
// otherwise.  xt, yt: the feature-major copies of the lane's X and Y.
template <int KIND, int BK, int BT>
__global__ void __launch_bounds__(threads_of(BT), BT == 128 ? 2 : 8)
pairwise_tile_kernel(const float* __restrict__ xt,
                     const float* __restrict__ yt, long long ldn,
                     long long ldm, const float* __restrict__ nx,
                     const float* __restrict__ ny, float* __restrict__ out,
                     int n, int m, int d, int tri, int zero_diag,
                     int stream) {
    constexpr int G = BT / TM;          // row groups = column groups
    constexpr int THREADS = G * G;
    constexpr int WARPS = THREADS / 32;
    constexpr int HALF = BT / 2;
    extern __shared__ __align__(16) float smem[];
    const long long lane_z = blockIdx.y;
    xt += lane_z * d * ldn;
    yt += lane_z * d * ldm;
    if (nx != nullptr) nx += lane_z * n;
    if (ny != nullptr) ny += lane_z * m;
    out += lane_z * n * m;

    int I, J;
    const long long t = blockIdx.x;
    if (tri) {   // t = J (J + 1) / 2 + I, 0 <= I <= J
        long long j = static_cast<long long>(
            (sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
        while ((j + 1) * (j + 2) / 2 <= t) ++j;
        while (j * (j + 1) / 2 > t) --j;
        J = static_cast<int>(j);
        I = static_cast<int>(t - j * (j + 1) / 2);
    } else {
        const int tm = (m + BT - 1) / BT;
        I = static_cast<int>(t / tm);
        J = static_cast<int>(t % tm);
    }
    const int row0 = I * BT;
    const int col0 = J * BT;
    // Thread (tx, ty) owns rows 4 ty + u and HALF + 4 ty + u of the tile,
    // columns 4 tx + v and HALF + 4 tx + v (u, v < 4).  A warp holds 4
    // consecutive tx and 8 consecutive ty (measured faster than 8 x 4 at
    // (16,384, 32) and (8, 2,048, 64) on an H100, the same elsewhere).
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int tx = (lane & 3) + 4 * (warp % (G / 4));
    const int ty = (lane >> 2) + 8 * (warp / (G / 4));

    // The tile's norms go with the first chunk, into shared memory past
    // the staging buffers, so the epilogue does not wait on global loads.
    float* norms_s = smem + smem_bytes(BT, BK) / sizeof(float) - 2 * BT;
    if (nx != nullptr) {
        for (int e = threadIdx.x; e < 2 * BT; e += THREADS) {
            const int i = e < BT ? row0 + e : col0 + e - BT;
            const bool ok = i < (e < BT ? n : m);
            const float* src = e < BT ? nx : ny;
            cp_async<4>(norms_s + e, ok ? src + i : src, ok ? 4 : 0);
        }
    }
    const int nchunks = (d + BK - 1) / BK;
    auto stage_chunk = [&](int g) {
        if (g < nchunks) {
            float* xs = smem + (g & 1) * 2 * BK * BT;
            stage<BK, BT, THREADS>(xs, xt, ldn, d, row0, g * BK);
            stage<BK, BT, THREADS>(xs + BK * BT, yt, ldm, d, col0, g * BK);
        }
        cp_async_commit();
    };
    stage_chunk(0);

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int g = 0; g < nchunks; ++g) {
        stage_chunk(g + 1);
        cp_async_wait_one();
        __syncthreads();
        const float* xs = smem + (g & 1) * 2 * BK * BT;
        const float* ys = xs + BK * BT;
#pragma unroll 4
        for (int k = 0; k < BK; ++k) {   // features in ascending order
            const float4 a0 = *reinterpret_cast<const float4*>(
                xs + k * BT + 4 * ty);
            const float4 a1 = *reinterpret_cast<const float4*>(
                xs + k * BT + HALF + 4 * ty);
            const float4 b0 = *reinterpret_cast<const float4*>(
                ys + k * BT + 4 * tx);
            const float4 b1 = *reinterpret_cast<const float4*>(
                ys + k * BT + HALF + 4 * tx);
            const float a[TM] = {a0.x, a0.y, a0.z, a0.w,
                                 a1.x, a1.y, a1.z, a1.w};
            const float b[TN] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = accumulate<KIND>(acc[i][j], a[i], b[j]);
        }
        __syncthreads();   // the buffer is refilled two chunks on, or
                           // taken by the tile's copy
    }

    // Finish in place; local row i of the thread is 4 ty + i (i < 4) or
    // HALF + 4 ty + i - 4, local column j likewise with tx.
    const int r0 = row0 + 4 * ty;
    const int c0 = col0 + 4 * tx;
    float nc[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
        nc[j] = nx != nullptr
            ? norms_s[BT + 4 * tx + (j < 4 ? j : HALF + j - 4)] : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = r0 + (i < 4 ? i : HALF + i - 4);
        const float nr = nx != nullptr
            ? norms_s[4 * ty + (i < 4 ? i : HALF + i - 4)] : 0.0f;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int c = c0 + (j < 4 ? j : HALF + j - 4);
            acc[i][j] = (zero_diag && r == c)
                ? 0.0f : finish<KIND>(acc[i][j], nr, nc[j]);
        }
    }
    // Block (I, J).  Rows of a multiple of 4 floats: straight from
    // registers, four columns a store.  Otherwise through a row-major copy
    // in shared memory, each warp writing whole rows of the tile.
    if ((m & 3) == 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int r = r0 + (i < 4 ? i : HALF + i - 4);
            if (r >= n) continue;
            float* row = out + static_cast<size_t>(r) * m;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int c = c0 + h * HALF;
                if (c < m)
                    put4(row + c, make_float4(acc[i][4 * h],
                                              acc[i][4 * h + 1],
                                              acc[i][4 * h + 2],
                                              acc[i][4 * h + 3]), stream);
            }
        }
    } else {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                *reinterpret_cast<float4*>(
                    smem + (4 * ty + (i & 3) + (i >> 2) * HALF) * BT
                    + 4 * tx + h * HALF) =
                    make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                                acc[i][4 * h + 2], acc[i][4 * h + 3]);
        __syncthreads();
        for (int rr = warp; rr < BT && row0 + rr < n; rr += WARPS) {
            float* row = out + static_cast<size_t>(row0 + rr) * m + col0;
            for (int cc = lane; cc < BT && col0 + cc < m; cc += 32)
                put(row + cc, smem[rr * BT + cc], stream);
        }
    }
    if (!tri || I == J) return;   // CTA-uniform
    // The mirror, block (J, I): column j of the tile is row c of R, and a
    // thread's four rows 4 ty + u are four contiguous entries of it.  All
    // BT rows of block I lie below col0 <= n - 1.  n a multiple of 4: from
    // registers, a float4 a store; otherwise through a column-major copy
    // (its groups of four rows XOR-swizzled by the column's group mod 8),
    // each warp writing whole rows of the mirror.
    if ((n & 3) == 0) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int c = c0 + (j < 4 ? j : HALF + j - 4);
            if (c >= n) continue;
            float* row = out + static_cast<size_t>(c) * n;
#pragma unroll
            for (int h = 0; h < 2; ++h)
                put4(row + r0 + h * HALF,
                     make_float4(acc[4 * h][j], acc[4 * h + 1][j],
                                 acc[4 * h + 2][j], acc[4 * h + 3][j]),
                     stream);
        }
        return;
    }
    __syncthreads();   // the row-major copy has been written out
#pragma unroll
    for (int j = 0; j < TN; ++j) {
        const int cl = 4 * tx + (j & 3) + (j >> 2) * HALF;
#pragma unroll
        for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float4*>(
                smem + cl * BT + (((ty + h * G) ^ ((cl >> 2) & 7)) << 2)) =
                make_float4(acc[4 * h][j], acc[4 * h + 1][j],
                            acc[4 * h + 2][j], acc[4 * h + 3][j]);
    }
    __syncthreads();
    for (int cc = warp; cc < BT && col0 + cc < n; cc += WARPS) {
        float* row = out + static_cast<size_t>(col0 + cc) * n + row0;
        for (int rr = lane; rr < BT; rr += 32)
            put(row + rr,
                smem[cc * BT + (((rr >> 2) ^ ((cc >> 2) & 7)) << 2)
                     + (rr & 3)], stream);
    }
}

template <int KIND, int BK, int BT>
cudaError_t launch_tiles(const Scratch& sc, float* out, int b, int n, int m,
                         int d, int tri, int zero_diag, int stream,
                         const float* nx, const float* ny, cudaStream_t s) {
    const size_t smem = smem_bytes(BT, BK);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            pairwise_tile_kernel<KIND, BK, BT>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    const long long tiles = tile_count(BT, n, m, tri);
    if (tiles > 0x7fffffffll) return cudaErrorInvalidValue;
    pairwise_tile_kernel<KIND, BK, BT>
        <<<dim3(static_cast<unsigned>(tiles), b), threads_of(BT), smem, s>>>(
            sc.xt, sc.yt, sc.ldn, sc.ldm, nx, ny, out, n, m, d, tri,
            zero_diag, stream);
    return cudaGetLastError();
}

template <int KIND, int BK>
cudaError_t launch_bt(const Scratch& sc, float* out, int b, int n, int m,
                      int d, int tri, int zero_diag, int stream,
                      const float* nx, const float* ny, cudaStream_t s) {
    if (tile_count(128, n, m, tri) * b >= BIG_TILE_MIN)
        return launch_tiles<KIND, BK, 128>(sc, out, b, n, m, d, tri, zero_diag, stream, nx, ny, s);
    return launch_tiles<KIND, BK, 64>(sc, out, b, n, m, d, tri, zero_diag, stream, nx, ny, s);
}

template <int KIND>
cudaError_t launch_bk(const Scratch& sc, float* out, int b, int n, int m,
                      int d, int tri, int zero_diag, int stream,
                      const float* nx, const float* ny, cudaStream_t s) {
    if (d <= 8) return launch_bt<KIND, 8>(sc, out, b, n, m, d, tri, zero_diag, stream, nx, ny, s);
    if (d <= 16) return launch_bt<KIND, 16>(sc, out, b, n, m, d, tri, zero_diag, stream, nx, ny, s);
    return launch_bt<KIND, 32>(sc, out, b, n, m, d, tri, zero_diag, stream, nx, ny, s);
}

template <typename T>
cudaError_t launch_prepass(const void* X, const void* Y, int b, int n, int m,
                           int d, int take, const Scratch& sc,
                           cudaStream_t stream) {
    const long long blocks = b * ((n + PRE_ROWS - 1) / PRE_ROWS)
        + (Y != nullptr ? (m + PRE_ROWS - 1) / PRE_ROWS : 0);
    if (blocks > 0x7fffffffll) return cudaErrorInvalidValue;
    prepass_kernel<T><<<static_cast<unsigned>(blocks), 32 * PRE_ROWS, 0,
                        stream>>>(
        static_cast<const T*>(X), static_cast<const T*>(Y), b, n, m, d, take,
        sc.norms_x, sc.norms_y, sc.xt, sc.yt, sc.ldn, sc.ldm);
    return cudaGetLastError();
}

// b lanes of (n, d) X against (m, d) Y (b = 1 for one matrix; a batch is
// always a self-matrix, Y = X), with the scratch of layout(): the pre-pass
// (norms of the gram kinds and cosine; the feature-major f32 copies), then
// the tiles.
cudaError_t run(const void* X, const void* Y, float* scratch, float* out,
                int b, int n, int m, int d, int kind, int is_bf16, int y_is_x,
                int zero_diag, cudaStream_t s) {
    const int take = (kind == GRAM_SQEUCLIDEAN || kind == GRAM_EUCLIDEAN)
        ? 1 : kind == COSINE ? 2 : 0;
    const Scratch sc = layout(scratch, b, n, m, d, y_is_x);
    const void* Yp = y_is_x ? nullptr : Y;
    const cudaError_t err = is_bf16
        ? launch_prepass<__nv_bfloat16>(X, Yp, b, n, m, d, take, sc, s)
        : launch_prepass<float>(X, Yp, b, n, m, d, take, sc, s);
    if (err != cudaSuccess) return err;
    const float* nx = take != 0 ? sc.norms_x : nullptr;
    const float* ny = take != 0 ? sc.norms_y : nullptr;
    const int stream = static_cast<long long>(b) * n * m * 4 >= STREAM_MIN_BYTES;
    const int tri = y_is_x;
    switch (kind) {
        case GRAM_SQEUCLIDEAN:
            return launch_bk<GRAM_SQEUCLIDEAN>(sc, out, b, n, m, d, tri, zero_diag, stream, nx, ny, s);
        case GRAM_EUCLIDEAN:
            return launch_bk<GRAM_EUCLIDEAN>(sc, out, b, n, m, d, tri, zero_diag, stream, nx, ny, s);
        case COSINE:
            return launch_bk<COSINE>(sc, out, b, n, m, d, tri, zero_diag, stream, nx, ny, s);
        case DIRECT_SQEUCLIDEAN:
            return launch_bk<DIRECT_SQEUCLIDEAN>(sc, out, b, n, m, d, tri, zero_diag, stream, nx, ny, s);
        case DIRECT_EUCLIDEAN:
            return launch_bk<DIRECT_EUCLIDEAN>(sc, out, b, n, m, d, tri, zero_diag, stream, nx, ny, s);
        case MANHATTAN:
            return launch_bk<MANHATTAN>(sc, out, b, n, m, d, tri, zero_diag, stream, nx, ny, s);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// The message of a cudaError_t, for the Python wrappers' exceptions.
extern "C" const char* repro_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// f32 words of the scratch repro_pairwise_dist (b = 1) and
// repro_pairwise_dist_batch (m = n, y_is_x = 1) take: the row norms and the
// feature-major copies of X and Y.
extern "C" long long repro_pairwise_scratch_words(int b, int n, int m, int d,
                                                  int y_is_x) {
    return layout(nullptr, b, n, m, d, y_is_x).words;
}

// X (n, d) and Y (m, d) row-major, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// out (n, m) f32; scratch of repro_pairwise_scratch_words(1, n, m, d,
// y_is_x) f32 words, 16-byte aligned.  y_is_x: Y is X (m == n; only one
// triangle of tiles is computed); zero_diag (only with y_is_x): the
// diagonal is written as exactly 0.  Returns the first cudaGetLastError()
// that is not cudaSuccess.
extern "C" int repro_pairwise_dist(const void* X, const void* Y,
                                   float* scratch, float* out, int n, int m,
                                   int d, int kind, int is_bf16, int y_is_x,
                                   int zero_diag, void* stream) {
    if (n < 1 || m < 1 || d < 1 || (y_is_x && m != n)
            || (zero_diag && !y_is_x))
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(run(X, Y, scratch, out, 1, n, m, d, kind,
                                is_bf16, y_is_x, zero_diag,
                                static_cast<cudaStream_t>(stream)));
}

// X (b, n, d) row-major, f32 or bf16; out (b, n, n) f32, lane z the
// self-matrix of X[z] with an exactly-zero diagonal; scratch of
// repro_pairwise_scratch_words(b, n, n, d, 1) f32 words, 16-byte aligned.
// 1 <= b <= 65,535.
extern "C" int repro_pairwise_dist_batch(const void* X, float* scratch,
                                         float* out, int b, int n, int d,
                                         int kind, int is_bf16,
                                         void* stream) {
    if (b < 1 || b > 65535 || n < 1 || d < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(run(X, X, scratch, out, b, n, n, d, kind,
                                is_bf16, 1, 1,
                                static_cast<cudaStream_t>(stream)));
}

// aux (n,) f32 of X (n, d) for the Prim kernels, with the pre-pass above:
// squared row norms (take_sqrt = 0: euclidean, sqeuclidean) or norms
// (take_sqrt = 1: cosine), the very values the gram and cosine tiles use.
extern "C" int repro_metric_aux(const void* X, int n, int d, int take_sqrt,
                                int is_bf16, float* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    Scratch sc{};
    sc.norms_x = out;
    const int take = take_sqrt ? 2 : 1;
    const cudaError_t err = is_bf16
        ? launch_prepass<__nv_bfloat16>(X, nullptr, 1, n, 0, d, take, sc, s)
        : launch_prepass<float>(X, nullptr, 1, n, 0, d, take, sc, s);
    return static_cast<int>(err);
}
