// One fused matrix-free Prim step: the flashvat rung's stepwise engine
// (turbo=False), CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/prim_stream.py::prim_stream_step_pallas (the
// TPU kernel _prim_stream_kernel, through _stream_call, with the pivot
// given by index), and with repro_prim_stream_step_batch
// prim_stream_step_pallas_batch (:265, its (b, nblk) slab-of-one grid, the
// batched stepwise engine of vat_matrix_free_batch).  For every lane j:
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
// and their mind is folded like any other lane.  The pivot by value (the
// sharded engine's prim_frontier_step) would be this kernel with x_q from a
// pointer to a point; it is not ported yet.
//
// The batch: a grid (nblocks, b), lane z = blockIdx.y, every operand at its
// lane's stride and the pivot read from q[z]; each lane's CTAs write their
// keys to that lane's partials, and the second pass is one CTA per lane.  So
// each lane runs exactly a single step's code and gives its bits, and the
// host loop still never syncs.  gridDim.y caps a batch at 65,535 lanes.
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
