// k nearest candidates of every query, CUDA C++ for sm_90a: the kNN graph of
// the approx rung.
//
// Replaces: src/repro/kernels/knn_graph.py::knn_graph_pallas (the TPU
// kernel, pallas_call at :164; its running top-k fold is _fold_topk, :65),
// and with repro_knn_topk_batch knn_graph_pallas_batch (:187, pallas_call at
// :211), the same fold per lane of a (b, n, d) stack.
// In query/candidate form it also does the work of the reference's per-cell
// _cell_topk (src/repro/core/approx_mst.py:354) and of the anchored
// assignment's pairwise tiles + lax.top_k (approx_mst.py:424).
//
// For each query row i and candidate column j the kernel computes the
// gram-form dissimilarity of the metric (always gram, as the reference
// does, knn_graph.py:92-95), masks a candidate with cid[j] < 0 or
// cid[j] == qid[i], and keeps the k smallest, ascending by (value,
// candidate id): the lower id wins a tie.  A slot that no valid candidate
// fills holds (+inf, -1).  The exact kNN graph is the call with
// Xq = Xc = X and qid = cid = 0..n-1.
//
// What bounds it on the H100: operations.  At the top of the exact-kNN
// window (n = 32,768, d = 64, k = 15) the function needs each pair once, one
// triangle of the (symmetric) matrix: 2 * d * n (n - 1) / 2 = 6.9e10 f32
// flops, 1.03 ms at 67 TFLOP/s.  Its bytes are negligible: X is 8 MiB and
// the output n * k * 12 B = 5.9 MB, together 4.2 us at 3.35 TB/s.  This
// kernel computes both triangles (2 * d * n^2 flops, twice the bound) plus,
// per pair, one compare of a packed key against the row's current k-th
// key; an insertion into the sorted list happens only when that compare
// passes, about k ln(n / k) times a row for candidates in random order.
// TF32 and the tensor cores are ruled out, as for every kernel of the port:
// numerics/condition.py derives KAPPA_SAFE from the f32 epsilon.  Splitting
// the Gram tiles over mma in split-f32, one triangle of tiles, and a
// warp-per-row top-k are later work.  A batch of b = 4 graphs at that size
// needs b times the flops: 4.1 ms.
//
// Design: the TPU kernel keeps a (BM, k) best slab resident while its grid's
// last axis sweeps the column tiles in order, and gets the lower-index tie
// rule from that order.  On Hopper blocks run in no order and nothing
// carries over between them, so:
//   * one CTA of 256 threads owns 64 query rows and itself loops over all
//     candidate tiles of 64 columns; no merge across CTAs is needed;
//   * the tie rule comes from the key, not from the sweep order: each
//     candidate is the 64-bit key ordered_bits(value) << 32 | id
//     (argmin_key.cuh), so an unsigned compare is exactly (value, id)
//     lexicographic, and the k smallest keys are the same set whatever
//     order they arrive in;
//   * each row keeps its k keys sorted in shared memory (64 * k * 8 B, 64
//     KiB at k = 128, so the launch raises the dynamic shared-memory limit
//     above 48 KiB with cudaFuncSetAttribute);
//   * a tile is computed as pairwise_dist.cu computes its tiles (features
//     staged 16 at a time in shared memory, a 4 x 4 block of f32
//     accumulators per thread, fmaf in one ascending feature order, the
//     epilogue finish<KIND> of dissim.cuh), with aux from the pairwise
//     kernel's own row-norm pre-pass, so every value the kernel sees equals
//     the pairwise_dist kernel's entry for the same pair bit for bit;
//   * each thread compares its 16 keys with its rows' k-th keys as they
//     stood before the tile, and marks the ones below in a per-row 64-bit
//     mask (the value goes to shared memory); then one thread per row
//     inserts the marked candidates into its list, re-checking each against
//     the list's current k-th key.  A stale threshold only lets more
//     candidates through, never fewer.
// The batch: a grid (n / 64, b), lane z = blockIdx.y; the points, their aux,
// and the outputs sit at the lane's stride, the ids (0..n-1, lane-local) are
// shared.  Each lane runs exactly the single graph's code, so its lists are
// the single call's bits.  gridDim.y caps a batch at 65,535 lanes.
#include <cuda_runtime.h>

#include "argmin_key.cuh"
#include "dissim.cuh"

namespace {

using namespace repro_torch;  // ArgKey, pack_key, Kind, accumulate, finish

constexpr int BM = 64;        // query rows per CTA
constexpr int BN = 64;        // candidates per tile (one bit each in a mask)
constexpr int BK = 16;        // features staged per shared-memory pass
constexpr int TM = 4;         // accumulator rows per thread
constexpr int TN = 4;         // accumulator columns per thread
constexpr int THREADS = 256;  // (BM / TM) * (BN / TN)
constexpr int PAD = 4;        // keeps float4 alignment, spreads banks
constexpr int MAX_K = 128;    // the reference's MAX_PALLAS_K

// Dynamic shared memory of one CTA for k neighbours: the sorted lists,
// each row's k-th key, the per-row masks, the tile's candidate ids and the
// tile's values.
__host__ __device__ constexpr size_t smem_bytes(int k) {
    return sizeof(ArgKey) * (static_cast<size_t>(BM) * k + BM + BM + BN)
        + sizeof(float) * BM * (BN + 1);
}

// The f32 value packed into a key (argmin_key.cuh's ordered_bits, undone).
__device__ __forceinline__ float key_value(ArgKey key) {
    const unsigned hi = static_cast<unsigned>(key >> 32);
    return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
knn_topk_kernel(const float* __restrict__ Xq, const float* __restrict__ Xc,
                const float* __restrict__ aq, const float* __restrict__ ac,
                const long long* __restrict__ qid,
                const long long* __restrict__ cid, int nq, int nc, int d,
                int k, float* __restrict__ out_d,
                long long* __restrict__ out_i) {
    __shared__ __align__(16) float xs[BK][BM + PAD];
    __shared__ __align__(16) float ys[BK][BN + PAD];
    extern __shared__ __align__(16) unsigned char smem[];
    ArgKey* best = reinterpret_cast<ArgKey*>(smem);         // [BM][k]
    ArgKey* kth = best + static_cast<size_t>(BM) * k;       // [BM]
    unsigned long long* marks = kth + BM;                    // [BM]
    long long* ids = reinterpret_cast<long long*>(marks + BM);  // [BN]
    float* vals = reinterpret_cast<float*>(ids + BN);        // [BM][BN + 1]

    // The lane of a batch (0 for one graph): points, aux and outputs at its
    // stride; the ids are the lane's own 0..n-1, shared by every lane.
    const size_t lane = blockIdx.y;
    Xq += lane * nq * d;
    Xc += lane * nc * d;
    if (aq != nullptr) aq += lane * nq;
    if (ac != nullptr) ac += lane * nc;
    out_d += lane * nq * k;
    out_i += lane * nq * k;

    const int tx = threadIdx.x % (BN / TN);
    const int ty = threadIdx.x / (BN / TN);
    const int row0 = blockIdx.x * BM;

    for (int e = threadIdx.x; e < BM * k; e += THREADS) best[e] = kMaxKey;
    if (threadIdx.x < BM) {
        kth[threadIdx.x] = kMaxKey;
        marks[threadIdx.x] = 0ull;
    }
    float arow[TM];
    long long qrow[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int r = row0 + ty * TM + i;
        arow[i] = (aq != nullptr && r < nq) ? aq[r] : 0.0f;
        qrow[i] = r < nq ? qid[r] : 0;
    }

    for (int col0 = 0; col0 < nc; col0 += BN) {
        if (threadIdx.x < BN) {
            const int c = col0 + threadIdx.x;
            ids[threadIdx.x] = c < nc ? cid[c] : -1;
        }
        float acc[TM][TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

        for (int k0 = 0; k0 < d; k0 += BK) {
            // Consecutive threads read consecutive features of one point;
            // features past d are zero, the identity of every accumulation.
            for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
                const int p = e / BK;
                const int f = e % BK;
                const int gk = k0 + f;
                const int gq = row0 + p;
                const int gc = col0 + p;
                xs[f][p] = (gq < nq && gk < d)
                    ? Xq[static_cast<size_t>(gq) * d + gk] : 0.0f;
                ys[f][p] = (gc < nc && gk < d)
                    ? Xc[static_cast<size_t>(gc) * d + gk] : 0.0f;
            }
            __syncthreads();
#pragma unroll
            for (int f = 0; f < BK; ++f) {
                const float4 a = *reinterpret_cast<const float4*>(&xs[f][ty * TM]);
                const float4 b = *reinterpret_cast<const float4*>(&ys[f][tx * TN]);
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

        // Mark the candidates below their row's k-th key.
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int rl = ty * TM + i;
            if (row0 + rl >= nq) continue;
            const ArgKey bar = kth[rl];
            unsigned long long mine = 0ull;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int cl = tx * TN + j;
                const int c = col0 + cl;
                if (c >= nc) continue;
                const long long id = ids[cl];
                if (id < 0 || id == qrow[i]) continue;
                const float v = finish<KIND>(acc[i][j], arow[i],
                                             ac != nullptr ? ac[c] : 0.0f);
                if (pack_key(v, static_cast<unsigned>(id)) < bar) {
                    vals[rl * (BN + 1) + cl] = v;
                    mine |= 1ull << cl;
                }
            }
            if (mine) atomicOr(&marks[rl], mine);
        }
        __syncthreads();

        // One thread per row inserts its marked candidates, in column order.
        if (threadIdx.x < BM) {
            const int rl = threadIdx.x;
            unsigned long long m = marks[rl];
            if (m) {
                ArgKey* list = best + static_cast<size_t>(rl) * k;
                while (m) {
                    const int cl = __ffsll(static_cast<long long>(m)) - 1;
                    m &= m - 1;
                    const ArgKey key = pack_key(vals[rl * (BN + 1) + cl],
                                                static_cast<unsigned>(ids[cl]));
                    if (key < list[k - 1]) {
                        int p = k - 1;
                        while (p > 0 && list[p - 1] > key) {
                            list[p] = list[p - 1];
                            --p;
                        }
                        list[p] = key;
                    }
                }
                marks[rl] = 0ull;
                kth[rl] = list[k - 1];
            }
        }
        __syncthreads();
    }

    // Lists out, row-major (nq, k); an empty slot is (+inf, -1).
    for (int e = threadIdx.x; e < BM * k; e += THREADS) {
        const int r = row0 + e / k;
        if (r >= nq) continue;
        const ArgKey key = best[e];
        const size_t o = static_cast<size_t>(row0) * k + e;
        if (key == kMaxKey) {
            out_d[o] = __int_as_float(0x7f800000);
            out_i[o] = -1;
        } else {
            out_d[o] = key_value(key);
            out_i[o] = static_cast<long long>(key_index(key));
        }
    }
}

template <int KIND>
cudaError_t launch(const float* Xq, const float* Xc, const float* aq,
                   const float* ac, const long long* qid,
                   const long long* cid, int b, int nq, int nc, int d, int k,
                   float* out_d, long long* out_i, cudaStream_t stream) {
    const size_t smem = smem_bytes(k);
    cudaError_t err = cudaFuncSetAttribute(
        knn_topk_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((nq + BM - 1) / BM, b);
    knn_topk_kernel<KIND><<<grid, THREADS, smem, stream>>>(
        Xq, Xc, aq, ac, qid, cid, nq, nc, d, k, out_d, out_i);
    return cudaGetLastError();
}

int dispatch(const float* Xq, const float* Xc, const float* aq,
             const float* ac, const long long* qid, const long long* cid,
             int b, int nq, int nc, int d, int k, int kind, float* out_d,
             long long* out_i, cudaStream_t s) {
    if (k < 1 || k > MAX_K || nq < 1 || nc < 1 || d < 1 || b < 1
            || b > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err;
    switch (kind) {
        case GRAM_SQEUCLIDEAN:
            err = launch<GRAM_SQEUCLIDEAN>(Xq, Xc, aq, ac, qid, cid, b, nq, nc, d, k, out_d, out_i, s);
            break;
        case GRAM_EUCLIDEAN:
            err = launch<GRAM_EUCLIDEAN>(Xq, Xc, aq, ac, qid, cid, b, nq, nc, d, k, out_d, out_i, s);
            break;
        case COSINE:
            err = launch<COSINE>(Xq, Xc, aq, ac, qid, cid, b, nq, nc, d, k, out_d, out_i, s);
            break;
        case MANHATTAN:
            err = launch<MANHATTAN>(Xq, Xc, aq, ac, qid, cid, b, nq, nc, d, k, out_d, out_i, s);
            break;
        default:
            err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}

}  // namespace

// The largest k the kernel takes; the wrapper reads it once.
extern "C" int repro_knn_max_k() { return MAX_K; }

// Xq (nq, d) and Xc (nc, d) f32 row-major; aq (nq,) and ac (nc,) their aux
// (squared row norms for the gram euclidean kinds, norms for cosine, null
// for manhattan); qid (nq,) and cid (nc,) int64 ids, each id below 2^32 or
// negative; 1 <= k <= MAX_K.  out_d (nq, k) f32 and out_i (nq, k) int64.
// kind is a gram kind of dissim.cuh: 0, 1, 2 or 5.  Returns the first CUDA
// error of the launch (cudaErrorInvalidValue for a kind or k it refuses).
extern "C" int repro_knn_topk(const float* Xq, const float* Xc,
                              const float* aq, const float* ac,
                              const long long* qid, const long long* cid,
                              int nq, int nc, int d, int k, int kind,
                              float* out_d, long long* out_i, void* stream) {
    return dispatch(Xq, Xc, aq, ac, qid, cid, 1, nq, nc, d, k, kind, out_d,
                    out_i, static_cast<cudaStream_t>(stream));
}

// The batch: X (b, n, d) f32, aux (b, n) (null for manhattan), ids (n,) int64
// = 0..n-1, each lane's graph over its own points; out_d (b, n, k) f32 and
// out_i (b, n, k) int64, lane-local ids.  1 <= b <= 65,535, 1 <= k <= MAX_K.
extern "C" int repro_knn_topk_batch(const float* X, const float* aux,
                                    const long long* ids, int b, int n, int d,
                                    int k, int kind, float* out_d,
                                    long long* out_i, void* stream) {
    return dispatch(X, X, aux, aux, ids, ids, b, n, n, d, k, kind, out_d,
                    out_i, static_cast<cudaStream_t>(stream));
}
