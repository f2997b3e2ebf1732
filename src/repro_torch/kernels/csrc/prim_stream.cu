// One fused matrix-free Prim step: the flashvat rung's stepwise engine
// (turbo=False) and the sharded engine's per-rank step, CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/prim_stream.py::prim_stream_step_pallas (the
// TPU kernel _prim_stream_kernel, through _stream_call, with the pivot
// given by index), with repro_prim_stream_step_batch
// prim_stream_step_pallas_batch (:265, its (b, nblk) slab-of-one grid, the
// batched stepwise engine of vat_matrix_free_batch), and with
// repro_prim_frontier_step prim_frontier_step_pallas (:175, the pivot given
// by value, the step of core/distributed.py::vat_matrix_free_sharded).
//
// The stepwise step: for every lane j
//   mind[j] = min(mind[j], dissim(x_j, x_q))          (updated in place)
// and out = the first-index (min, argmin) of mind over lanes with
// selected[j] false, as kernels/prim_update.cu writes it.
//
// What bounds it on the H100: one step reads X once (n d 4 bytes: 12.8 MB,
// 3.8 us at n = 50,000, d = 64) plus 9 bytes a lane of frontier, against
// n d FMAs (0.1 us at 67 TFLOP/s): bytes.  At these sizes a step is also
// near the launch latency, and n - 1 steps run in sequence from the host.
// A batched step of b = 4 lanes at n = 50,000 reads 51 MB of X: 15 us.
//
// Design: one thread per lane, 256 lanes per CTA.  The pivot index q is
// read from a device pointer (the previous step's output, or the seed), so
// the host loop never syncs; the pivot row is read by every thread of a
// warp at the same address (a broadcast).  A lane's value comes from
// pair_dissim (dissim.cuh), the code pairwise_dist.cu and prim_persist.cu
// run, so the stepwise, persistent and materialized engines agree bit for
// bit.  Each CTA reduces its lanes to one packed (value, index) key
// (argmin_key.cuh); a second one-CTA pass reduces the per-CTA keys and
// writes the pair into a 2-element device buffer.  Selected lanes enter the
// argmin as +inf through the selected mask, exactly as in the TPU kernel,
// and their mind is folded like any other lane.
//
// The batch: a grid (nblocks, b), lane z = blockIdx.y, every operand at its
// lane's stride and the pivot read from q[z]; each lane's CTAs write their
// keys to that lane's partials, and the second pass is one CTA per lane.  So
// each lane runs exactly a single step's code and gives its bits, and the
// host loop still never syncs.  gridDim.y caps a batch at 65,535 lanes.
//
// The frontier step (repro_prim_frontier_step), one rank's shard of n lanes
// with global ids offset + j.  The pivot comes by value, as a slot of the
// previous step's all-gathered table: P slots of W f32 words, each
// [key (int64), value, aux, x (d), zero padding] (kernels/ref.py,
// slot_width).  Every CTA takes the slot with the least key as the pivot
// (P is the world size: a scan of P keys); CTA 0 records its id and value
// as order[t] and edges[t]; the lane whose id is the pivot's is closed to
// +inf; every other lane folds in band:
//   mind[j] = isinf(mind[j]) ? +inf : fminf(mind[j], dissim(x_j, x_q))
// so a +inf lane (selected or padding) skips its dissimilarity and is never
// revived.  The packed key carries the global id, so the cross-rank choice
// is a min over P keys and, shards being contiguous row blocks, first-rank
// ties are first-index ties.  The last reduction (the only CTA, or the
// second pass) writes this rank's next slot: the key with its top bit
// flipped (a signed int64 compare then orders as the unsigned key), the
// winner's mind, its aux entry and its point, so one all_gather a step
// carries everything the next step needs, and the traversal never waits on
// the host.  Bound: one step reads the shard's X once plus 8 bytes a lane of
// frontier: 13.2 MB at n = 50,000, d = 64, one rank, 3.9 us; the choice,
// the record and the close cost a few reads of L2 a CTA.
#include <cuda_runtime.h>

#include "argmin_key.cuh"
#include "dissim.cuh"

namespace {

using namespace repro_torch;

constexpr int THREADS = 256;       // lanes per CTA of the step
constexpr int REDUCE_THREADS = 1024;

__device__ __forceinline__ void write_pair(ArgKey key,
                                           const float* __restrict__ mind,
                                           const unsigned char* __restrict__ sel,
                                           long long* __restrict__ out) {
    const unsigned idx = key_index(key);
    const float v = sel[idx] ? __int_as_float(0x7f800000) : mind[idx];
    out[0] = static_cast<long long>(idx);
    reinterpret_cast<float*>(out + 1)[0] = v;
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
prim_stream_step_kernel(const float* __restrict__ X,
                        const float* __restrict__ aux,
                        const long long* __restrict__ qp,
                        float* __restrict__ mind,
                        const unsigned char* __restrict__ sel, int n, int d,
                        ArgKey* __restrict__ partial,
                        long long* __restrict__ out) {
    __shared__ ArgKey scratch[THREADS / 32];
    const size_t lane = blockIdx.y;   // 0 for a single step
    X += lane * n * d;
    aux += lane * n;
    mind += lane * n;
    sel += lane * n;
    partial += lane * gridDim.x;
    out += 2 * lane;
    const int q = static_cast<int>(qp[lane]);
    const bool vec4 = rows_are_vec4(X, d);
    const int j = blockIdx.x * THREADS + threadIdx.x;
    ArgKey key = kMaxKey;
    if (j < n) {
        const float row = pair_dissim<KIND>(
            X + static_cast<size_t>(j) * d, X + static_cast<size_t>(q) * d,
            d, vec4, aux[j], aux[q]);
        const float m = fminf(mind[j], row);
        mind[j] = m;
        key = pack_key(sel[j] ? __int_as_float(0x7f800000) : m, j);
    }
    key = block_min_key(key, scratch);
    if (threadIdx.x != 0) return;
    if (gridDim.x == 1)
        write_pair(key, mind, sel, out);
    else
        partial[blockIdx.x] = key;
}

__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_partials_kernel(const ArgKey* __restrict__ partial, int nparts,
                       const float* __restrict__ mind,
                       const unsigned char* __restrict__ sel, int n,
                       long long* __restrict__ out) {
    __shared__ ArgKey scratch[REDUCE_THREADS / 32];
    const size_t lane = blockIdx.x;   // one CTA per lane
    partial += lane * nparts;
    mind += lane * n;
    sel += lane * n;
    out += 2 * lane;
    ArgKey key = kMaxKey;
    for (int i = threadIdx.x; i < nparts; i += REDUCE_THREADS)
        key = min_key(key, partial[i]);
    key = block_min_key(key, scratch);
    if (threadIdx.x == 0) write_pair(key, mind, sel, out);
}

template <int KIND>
cudaError_t launch(const float* X, const float* aux, const long long* q,
                   float* mind, const unsigned char* sel, int b, int n, int d,
                   ArgKey* partial, long long* out, cudaStream_t stream) {
    const int nblocks = (n + THREADS - 1) / THREADS;
    prim_stream_step_kernel<KIND><<<dim3(nblocks, b), THREADS, 0, stream>>>(
        X, aux, q, mind, sel, n, d, partial, out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || nblocks == 1) return err;
    reduce_partials_kernel<<<b, REDUCE_THREADS, 0, stream>>>(
        partial, nblocks, mind, sel, n, out);
    return cudaGetLastError();
}

int dispatch(const float* X, const float* aux, const long long* q,
             float* mind, const unsigned char* sel, int b, int n, int d,
             int kind, ArgKey* partial, long long* out, cudaStream_t s) {
    if (b < 1 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
    switch (kind) {
        case GRAM_SQEUCLIDEAN:
            return launch<GRAM_SQEUCLIDEAN>(X, aux, q, mind, sel, b, n, d, partial, out, s);
        case GRAM_EUCLIDEAN:
            return launch<GRAM_EUCLIDEAN>(X, aux, q, mind, sel, b, n, d, partial, out, s);
        case COSINE:
            return launch<COSINE>(X, aux, q, mind, sel, b, n, d, partial, out, s);
        case DIRECT_SQEUCLIDEAN:
            return launch<DIRECT_SQEUCLIDEAN>(X, aux, q, mind, sel, b, n, d, partial, out, s);
        case DIRECT_EUCLIDEAN:
            return launch<DIRECT_EUCLIDEAN>(X, aux, q, mind, sel, b, n, d, partial, out, s);
        case MANHATTAN:
            return launch<MANHATTAN>(X, aux, q, mind, sel, b, n, d, partial, out, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// ---- the frontier step (repro_prim_frontier_step) --------------------------

constexpr int SLOT_HEAD = 4;       // key (2 words), value, aux; then x

__device__ __forceinline__ long long slot_key(const float* slot) {
    return *reinterpret_cast<const long long*>(slot);
}

// The slot of `table` (P slots of W words) with the least signed key, the
// first among equal keys; every thread of every CTA scans the P keys.
__device__ __forceinline__ const float* least_slot(const float* __restrict__ table,
                                                   int P, int W) {
    const float* best = table;
    long long best_key = slot_key(table);
    for (int r = 1; r < P; ++r) {
        const float* slot = table + static_cast<size_t>(r) * W;
        const long long key = slot_key(slot);
        if (key < best_key) {
            best_key = key;
            best = slot;
        }
    }
    return best;
}

// This rank's slot from the reduced key, written by every thread of one
// CTA: the key with its top bit flipped, the winner's mind (its raw bits,
// the edge the solo engines record), aux entry and point, zero padding.
__device__ __forceinline__ void write_slot(ArgKey key, long long offset,
                                           const float* __restrict__ X,
                                           const float* __restrict__ aux,
                                           const float* __restrict__ mind,
                                           int d, int W, float* __restrict__ out) {
    const long long lane = static_cast<long long>(key_index(key)) - offset;
    if (threadIdx.x == 0) {
        *reinterpret_cast<long long*>(out) =
            static_cast<long long>(key ^ (1ull << 63));
        out[2] = mind[lane];
        out[3] = aux[lane];
    }
    const float* x = X + lane * d;
    for (int k = threadIdx.x; k < W - SLOT_HEAD; k += blockDim.x)
        out[SLOT_HEAD + k] = k < d ? x[k] : 0.0f;
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
prim_frontier_step_kernel(const float* __restrict__ X,
                          const float* __restrict__ aux,
                          const float* __restrict__ table, int P, int W,
                          float* __restrict__ mind, int n, int d,
                          long long offset, long long* __restrict__ order_t,
                          float* __restrict__ edge_t,
                          ArgKey* __restrict__ partial,
                          float* __restrict__ out) {
    __shared__ ArgKey scratch[THREADS / 32];
    const float* pivot = least_slot(table, P, W);
    const long long q = slot_key(pivot) & 0xffffffffll;
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        *order_t = q;
        *edge_t = pivot[2];
    }
    // every slot starts 16-byte aligned when the table does (W % 4 == 0)
    const bool vec4 = rows_are_vec4(X, d) && rows_are_vec4(table, W);
    const int j = blockIdx.x * THREADS + threadIdx.x;
    ArgKey key = kMaxKey;
    if (j < n) {
        float m = mind[j];
        if (offset + j == q) {
            m = __int_as_float(0x7f800000);
            mind[j] = m;
        } else if (!isinf(m)) {
            const float row = pair_dissim<KIND>(
                X + static_cast<size_t>(j) * d, pivot + SLOT_HEAD, d, vec4,
                aux[j], pivot[3]);
            m = fminf(m, row);
            mind[j] = m;
        }
        key = pack_key(m, static_cast<unsigned>(offset + j));
    }
    key = block_min_key(key, scratch);
    if (gridDim.x == 1)
        write_slot(key, offset, X, aux, mind, d, W, out);
    else if (threadIdx.x == 0)
        partial[blockIdx.x] = key;
}

__global__ void __launch_bounds__(REDUCE_THREADS)
frontier_reduce_kernel(const ArgKey* __restrict__ partial, int nparts,
                       long long offset, const float* __restrict__ X,
                       const float* __restrict__ aux,
                       const float* __restrict__ mind, int d, int W,
                       float* __restrict__ out) {
    __shared__ ArgKey scratch[REDUCE_THREADS / 32];
    ArgKey key = kMaxKey;
    for (int i = threadIdx.x; i < nparts; i += REDUCE_THREADS)
        key = min_key(key, partial[i]);
    key = block_min_key(key, scratch);
    write_slot(key, offset, X, aux, mind, d, W, out);
}

template <int KIND>
cudaError_t launch_frontier(const float* X, const float* aux,
                            const float* table, int P, int W, float* mind,
                            int n, int d, long long offset, long long* order_t,
                            float* edge_t, ArgKey* partial, float* out,
                            cudaStream_t stream) {
    const int nblocks = (n + THREADS - 1) / THREADS;
    prim_frontier_step_kernel<KIND><<<nblocks, THREADS, 0, stream>>>(
        X, aux, table, P, W, mind, n, d, offset, order_t, edge_t, partial,
        out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || nblocks == 1) return err;
    frontier_reduce_kernel<<<1, REDUCE_THREADS, 0, stream>>>(
        partial, nblocks, offset, X, aux, mind, d, W, out);
    return cudaGetLastError();
}

int dispatch_frontier(const float* X, const float* aux, const float* table,
                      int P, int W, float* mind, int n, int d, int kind,
                      long long offset, long long* order_t, float* edge_t,
                      ArgKey* partial, float* out, cudaStream_t s) {
    if (P < 1 || n < 1 || d < 1 || W < SLOT_HEAD + d || W % 4 != 0
            || offset < 0 || offset + n > 0xffffffffll)
        return static_cast<int>(cudaErrorInvalidValue);
    switch (kind) {
        case GRAM_SQEUCLIDEAN:
            return launch_frontier<GRAM_SQEUCLIDEAN>(X, aux, table, P, W, mind, n, d, offset, order_t, edge_t, partial, out, s);
        case GRAM_EUCLIDEAN:
            return launch_frontier<GRAM_EUCLIDEAN>(X, aux, table, P, W, mind, n, d, offset, order_t, edge_t, partial, out, s);
        case COSINE:
            return launch_frontier<COSINE>(X, aux, table, P, W, mind, n, d, offset, order_t, edge_t, partial, out, s);
        case DIRECT_SQEUCLIDEAN:
            return launch_frontier<DIRECT_SQEUCLIDEAN>(X, aux, table, P, W, mind, n, d, offset, order_t, edge_t, partial, out, s);
        case DIRECT_EUCLIDEAN:
            return launch_frontier<DIRECT_EUCLIDEAN>(X, aux, table, P, W, mind, n, d, offset, order_t, edge_t, partial, out, s);
        case MANHATTAN:
            return launch_frontier<MANHATTAN>(X, aux, table, P, W, mind, n, d, offset, order_t, edge_t, partial, out, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

// Lanes per CTA of the step; the wrapper sizes `partial` from it.
extern "C" int repro_prim_stream_lanes() { return THREADS; }

// X (n, d) f32 row-major, aux (n,) f32, q a device int64 (the pivot), mind
// (n,) f32 updated in place, sel (n,) bool as bytes.  out is a 2-element
// int64 buffer: out[0] = next vertex, the low 4 bytes of out[1] = its edge
// (f32).  partial holds ceil(n / lanes) keys of scratch when n > lanes.
extern "C" int repro_prim_stream_step(const float* X, const float* aux,
                                      const long long* q, float* mind,
                                      const unsigned char* sel, int n, int d,
                                      int kind, unsigned long long* partial,
                                      long long* out, void* stream) {
    return dispatch(X, aux, q, mind, sel, 1, n, d, kind, partial, out,
                    static_cast<cudaStream_t>(stream));
}

// The batched step: X (b, n, d) f32, aux (b, n), q (b,) device int64 (lane
// z's pivot), mind (b, n) updated in place, sel (b, n) bool as bytes; out
// (b, 2) int64, lane z's pair as above.  partial holds b ceil(n / lanes)
// keys when n > lanes.  1 <= b <= 65,535.
extern "C" int repro_prim_stream_step_batch(const float* X, const float* aux,
                                            const long long* q, float* mind,
                                            const unsigned char* sel, int b,
                                            int n, int d, int kind,
                                            unsigned long long* partial,
                                            long long* out, void* stream) {
    return dispatch(X, aux, q, mind, sel, b, n, d, kind, partial, out,
                    static_cast<cudaStream_t>(stream));
}

// The sharded engine's step on one rank: X (n, d) f32 the shard (global ids
// offset .. offset + n - 1), aux (n,), table (P, W) f32 the gathered slots
// of the last step (W = 4 + d rounded up to a multiple of 4, 16-byte
// aligned), mind (n,) f32 the in-band frontier, updated in place;
// order_t / edge_t the int64 / f32 entries that record the pivot; out (W,)
// f32 this rank's next slot.  partial holds ceil(n / lanes) keys of scratch
// when n > lanes.
extern "C" int repro_prim_frontier_step(const float* X, const float* aux,
                                        const float* table, int P, int W,
                                        float* mind, int n, int d, int kind,
                                        long long offset, long long* order_t,
                                        float* edge_t,
                                        unsigned long long* partial,
                                        float* out, void* stream) {
    return dispatch_frontier(X, aux, table, P, W, mind, n, d, kind, offset,
                             order_t, edge_t, partial, out,
                             static_cast<cudaStream_t>(stream));
}
