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
// What bounds it on the H100: on the main path (the self-matrix, n = 2,048,
// d = 64) R is symmetric, so the function needs only the n(n+1)/2 dot
// products on and above the diagonal, 0.27 GFLOP of f32 FMAs (4.1 us at
// 67 TFLOP/s), against 16 MiB of output (5.0 us at 3.35 TB/s): it is bound
// by the output bytes, and more so at small d.  This kernel computes every
// tile, the full 2*n*n*d; computing one triangle of tiles and mirroring it
// is later work.  Hopkins' rectangular calls (m = 204 probes against
// n = 2,048 points) are about even, 0.8 us of FMAs against 0.7 us of bytes.
// The batched self-matrices of fit_many (b = 8 lanes, n = 2,048, d = 64) are
// bound the same way: 134 MB of output, 40 us at 3.35 TB/s, against 2.2
// GFLOP for the eight lanes' triangles (32 us at 67 TFLOP/s).
// TF32 tensor cores are ruled out: numerics/condition.py derives KAPPA_SAFE
// from the f32 epsilon, and a 10-bit mantissa in the cross term would void
// that derivation.
//
// Design: one CTA of 256 threads per 64 x 64 output tile.  X and Y tiles of
// 16 features are staged in shared memory transposed (feature-major), and
// each thread keeps a 4 x 4 block of f32 accumulators in registers, fed by
// two float4 shared loads per feature.  The kernel computes its own offsets
// and masks the ragged n, m and d edges on load (zero features are the
// identity of every reduction here) and on store; nothing is padded in
// device memory.  Row norms come from a small pre-pass in this file (one
// warp per row), which also serves the Prim kernels their aux vector
// (repro_metric_aux).  The per-pair arithmetic lives in dissim.cuh, shared
// with prim_persist.cu and prim_stream.cu: every entry sums its features in
// one fixed ascending order with fmaf, and fmaf(x, y, a) == fmaf(y, x, a),
// (x - y)^2 == (y - x)^2 and |x - y| == |y - x| bit for bit, so
// R[i, j] == R[j, i] whichever tile computes it, and a matrix-free Prim row
// equals the matrix's row bit for bit.  Inputs are f32 or bf16
// storage; accumulation is always f32 and the output is f32.
//
// The batch ("slab of one", as the TPU kernel's batch grid): lane z of a
// (b, n, d) stack is blockIdx.z, and every operand of the tile kernel sits at
// that lane's stride, so a lane runs exactly the single matrix's code and
// its matrix equals the single call on that lane bit for bit.  The row-norm
// pre-pass runs over all b n rows in one launch (row-wise, so the same bits
// per row), and the batch writes each lane's diagonal as exactly 0 in the
// epilogue.  gridDim.z caps a batch at 65,535 lanes; the wrapper raises
// above it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dissim.cuh"

namespace {

constexpr int BM = 64;        // output tile rows (X points)
constexpr int BN = 64;        // output tile columns (Y points)
constexpr int BK = 16;        // features staged per shared-memory pass
constexpr int TM = 4;         // accumulator rows per thread
constexpr int TN = 4;         // accumulator columns per thread
constexpr int THREADS = 256;  // (BM / TM) * (BN / TN)
constexpr int PAD = 4;        // keeps float4 alignment, spreads banks

using namespace repro_torch;  // Kind, to_f32, accumulate, finish

// One warp per row: out[i] = sum_k X[i, k]^2 (or its sqrt for cosine).
template <typename T>
__global__ void row_norms_kernel(const T* __restrict__ X, int n, int d,
                                 int take_sqrt, float* __restrict__ out) {
    const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (row >= n) return;  // warp-uniform
    const float s = warp_row_norm(X + static_cast<size_t>(row) * d, d, lane,
                                  take_sqrt);
    if (lane == 0) out[row] = s;
}

template <typename T, int KIND>
__global__ void __launch_bounds__(THREADS)
pairwise_tile_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                     const float* __restrict__ nx,
                     const float* __restrict__ ny, float* __restrict__ out,
                     int n, int m, int d, int zero_diag) {
    __shared__ __align__(16) float xs[BK][BM + PAD];
    __shared__ __align__(16) float ys[BK][BN + PAD];
    // The lane of a batch (0 for one matrix): every operand at its stride.
    const size_t lane = blockIdx.z;
    X += lane * n * d;
    Y += lane * m * d;
    if (nx != nullptr) nx += lane * n;
    if (ny != nullptr) ny += lane * m;
    out += lane * n * m;
    const int tx = threadIdx.x % (BN / TN);
    const int ty = threadIdx.x / (BN / TN);
    const int row0 = blockIdx.y * BM;
    const int col0 = blockIdx.x * BN;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += BK) {
        // Consecutive threads read consecutive features of one point.
        for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
            const int p = e / BK;
            const int k = e % BK;
            const int gk = k0 + k;
            const int gx = row0 + p;
            const int gy = col0 + p;
            xs[k][p] = (gx < n && gk < d)
                ? to_f32(X[static_cast<size_t>(gx) * d + gk]) : 0.0f;
            ys[k][p] = (gy < m && gk < d)
                ? to_f32(Y[static_cast<size_t>(gy) * d + gk]) : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * TM]);
            const float4 b = *reinterpret_cast<const float4*>(&ys[k][tx * TN]);
            const float av[TM] = {a.x, a.y, a.z, a.w};
            const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = accumulate<KIND>(acc[i][j], av[i], bv[j]);
        }
        __syncthreads();
    }

    const bool vec_store = (m % 4) == 0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = row0 + ty * TM + i;
        if (r >= n) continue;
        const float nr = nx != nullptr ? nx[r] : 0.0f;
        float v[TN];
        const int c0 = col0 + tx * TN;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int c = c0 + j;
            const float nc = (ny != nullptr && c < m) ? ny[c] : 0.0f;
            v[j] = (zero_diag && c == r) ? 0.0f
                                          : finish<KIND>(acc[i][j], nr, nc);
        }
        float* dst = out + static_cast<size_t>(r) * m + c0;
        if (vec_store && c0 + TN <= m) {
            *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
            for (int j = 0; j < TN; ++j)
                if (c0 + j < m) dst[j] = v[j];
        }
    }
}

template <typename T, int KIND>
cudaError_t launch_tiles(const void* X, const void* Y, const float* nx,
                         const float* ny, float* out, int b, int n, int m,
                         int d, int zero_diag, cudaStream_t stream) {
    const dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM, b);
    pairwise_tile_kernel<T, KIND><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(X), static_cast<const T*>(Y), nx, ny, out, n, m,
        d, zero_diag);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_norms(const void* X, int n, int d, int take_sqrt,
                         float* out, cudaStream_t stream) {
    constexpr int kRowsPerBlock = 8;  // 8 warps
    row_norms_kernel<T><<<(n + kRowsPerBlock - 1) / kRowsPerBlock,
                          32 * kRowsPerBlock, 0, stream>>>(
        static_cast<const T*>(X), n, d, take_sqrt, out);
    return cudaGetLastError();
}

// b lanes of (n, d) X against (m, d) Y (b = 1 for one matrix; a batch is
// always a self-matrix, Y = X); the norms of all b n rows in one pre-pass.
template <typename T>
cudaError_t run(const void* X, const void* Y, float* norms_x, float* norms_y,
                float* out, int b, int n, int m, int d, int kind, int y_is_x,
                int zero_diag, cudaStream_t stream) {
    const bool needs_norms =
        kind == GRAM_SQEUCLIDEAN || kind == GRAM_EUCLIDEAN || kind == COSINE;
    const float* nx = nullptr;
    const float* ny = nullptr;
    if (needs_norms) {
        const int take_sqrt = kind == COSINE;
        cudaError_t err = launch_norms<T>(X, b * n, d, take_sqrt, norms_x,
                                          stream);
        if (err != cudaSuccess) return err;
        nx = norms_x;
        ny = norms_x;
        if (!y_is_x) {
            err = launch_norms<T>(Y, b * m, d, take_sqrt, norms_y, stream);
            if (err != cudaSuccess) return err;
            ny = norms_y;
        }
    }
    switch (kind) {
        case GRAM_SQEUCLIDEAN:
            return launch_tiles<T, GRAM_SQEUCLIDEAN>(X, Y, nx, ny, out, b, n, m, d, zero_diag, stream);
        case GRAM_EUCLIDEAN:
            return launch_tiles<T, GRAM_EUCLIDEAN>(X, Y, nx, ny, out, b, n, m, d, zero_diag, stream);
        case COSINE:
            return launch_tiles<T, COSINE>(X, Y, nx, ny, out, b, n, m, d, zero_diag, stream);
        case DIRECT_SQEUCLIDEAN:
            return launch_tiles<T, DIRECT_SQEUCLIDEAN>(X, Y, nx, ny, out, b, n, m, d, zero_diag, stream);
        case DIRECT_EUCLIDEAN:
            return launch_tiles<T, DIRECT_EUCLIDEAN>(X, Y, nx, ny, out, b, n, m, d, zero_diag, stream);
        case MANHATTAN:
            return launch_tiles<T, MANHATTAN>(X, Y, nx, ny, out, b, n, m, d, zero_diag, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// The message of a cudaError_t, for the Python wrappers' exceptions.
extern "C" const char* repro_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// X (n, d) and Y (m, d) row-major, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// out (n, m) f32.  norms_x (n,) and norms_y (m,) are f32 scratch for the
// gram and cosine kinds (unused otherwise; norms_y unused when y_is_x).
// Returns the first cudaGetLastError() that is not cudaSuccess.
extern "C" int repro_pairwise_dist(const void* X, const void* Y,
                                   float* norms_x, float* norms_y, float* out,
                                   int n, int m, int d, int kind, int is_bf16,
                                   int y_is_x, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = is_bf16
        ? run<__nv_bfloat16>(X, Y, norms_x, norms_y, out, 1, n, m, d, kind, y_is_x, 0, s)
        : run<float>(X, Y, norms_x, norms_y, out, 1, n, m, d, kind, y_is_x, 0, s);
    return static_cast<int>(err);
}

// X (b, n, d) row-major, f32 or bf16; out (b, n, n) f32, lane z the
// self-matrix of X[z] with an exactly-zero diagonal.  norms (b n,) f32
// scratch for the gram and cosine kinds.  1 <= b <= 65,535.
extern "C" int repro_pairwise_dist_batch(const void* X, float* norms,
                                         float* out, int b, int n, int d,
                                         int kind, int is_bf16, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (b < 1 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = is_bf16
        ? run<__nv_bfloat16>(X, X, norms, norms, out, b, n, n, d, kind, 1, 1, s)
        : run<float>(X, X, norms, norms, out, b, n, n, d, kind, 1, 1, s);
    return static_cast<int>(err);
}

// aux (n,) f32 of X (n, d) for the Prim kernels, with the pre-pass above:
// squared row norms (take_sqrt = 0: euclidean, sqeuclidean) or norms
// (take_sqrt = 1: cosine), the very values the gram and cosine tiles use.
extern "C" int repro_metric_aux(const void* X, int n, int d, int take_sqrt,
                                int is_bf16, float* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = is_bf16
        ? launch_norms<__nv_bfloat16>(X, n, d, take_sqrt, out, s)
        : launch_norms<float>(X, n, d, take_sqrt, out, s);
    return static_cast<int>(err);
}
