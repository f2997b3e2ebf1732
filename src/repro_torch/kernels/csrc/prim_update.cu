// Masked first-index argmin: (min over lanes where mask is false, its index).
//
// Replaces: src/repro/kernels/prim_update.py::masked_argmin_pallas (the TPU
// kernel _block_argmin_kernel plus the cross-block argmin its wrapper ran),
// also as the reference vmaps it over a batch (core/vat.py::vat_batch).
// Prim's ordering calls it once per step, n - 1 times per VAT fit, and once
// per step for a whole batch of b fits.
//
// What bounds it on the H100: the work is tiny (5 bytes and one compare per
// lane: 10 KiB at n = 2,048), so one call is bound by launch latency and by
// the dependent round trips of a block reduction, not by bandwidth or
// arithmetic.
//
// Design: one launch does the whole reduction for n <= 4,096 (1,024 threads,
// four lanes each): each thread folds its lanes into one packed
// (ordered value, index) key (argmin_key.cuh), then warp shuffles and one
// shared-memory round give the block minimum, and thread 0 writes the pair
// into a 2-element device buffer.  The packed key makes "first index wins"
// hold within a thread, a warp and a block alike, and no value ever goes
// back to the host.  Above 4,096 lanes each CTA writes its key to a scratch
// array and a second one-CTA pass reduces those keys the same way.  Masked
// lanes take +inf, so a fully masked vector returns (+inf, 0), as
// jnp.argmin does.  Negative values are ordered correctly; NaN is not
// accepted (see argmin_key.cuh).
//
// A batch (b, n) is one launch pair, not b: lane z is blockIdx.y of the
// first pass and blockIdx.x of the second, and every pointer sits at its
// lane's stride, so each lane runs exactly the code of a single vector and
// returns its pair bit for bit.  gridDim.y caps a batch at 65,535 lanes.
#include <cuda_runtime.h>

#include "argmin_key.cuh"

namespace {

using repro_torch::ArgKey;

constexpr int THREADS = 1024;
constexpr int ITEMS = 4;
constexpr int CHUNK = THREADS * ITEMS;  // lanes per CTA

__device__ __forceinline__ void write_pair(ArgKey key,
                                           const float* __restrict__ vals,
                                           const unsigned char* __restrict__ mask,
                                           long long* __restrict__ out) {
    const unsigned idx = repro_torch::key_index(key);
    const float v = mask[idx] ? __int_as_float(0x7f800000) : vals[idx];
    out[0] = static_cast<long long>(idx);
    reinterpret_cast<float*>(out + 1)[0] = v;
}

__global__ void __launch_bounds__(THREADS)
masked_argmin_kernel(const float* __restrict__ vals,
                     const unsigned char* __restrict__ mask, int n,
                     ArgKey* __restrict__ partial, long long* __restrict__ out) {
    __shared__ ArgKey scratch[THREADS / 32];
    const size_t lane = blockIdx.y;
    vals += lane * n;
    mask += lane * n;
    partial += lane * gridDim.x;
    out += 2 * lane;
    const float inf = __int_as_float(0x7f800000);
    const int begin = blockIdx.x * CHUNK;
    const int end = min(n, begin + CHUNK);
    ArgKey key = repro_torch::kMaxKey;
    for (int i = begin + threadIdx.x; i < end; i += THREADS)
        key = repro_torch::min_key(
            key, repro_torch::pack_key(mask[i] ? inf : vals[i], i));
    key = repro_torch::block_min_key(key, scratch);
    if (threadIdx.x != 0) return;
    if (gridDim.x == 1)
        write_pair(key, vals, mask, out);
    else
        partial[blockIdx.x] = key;
}

__global__ void __launch_bounds__(THREADS)
reduce_partials_kernel(const ArgKey* __restrict__ partial, int nparts,
                       const float* __restrict__ vals,
                       const unsigned char* __restrict__ mask, int n,
                       long long* __restrict__ out) {
    __shared__ ArgKey scratch[THREADS / 32];
    const size_t lane = blockIdx.x;   // one CTA per lane
    partial += lane * nparts;
    vals += lane * n;
    mask += lane * n;
    out += 2 * lane;
    ArgKey key = repro_torch::kMaxKey;
    for (int i = threadIdx.x; i < nparts; i += THREADS)
        key = repro_torch::min_key(key, partial[i]);
    key = repro_torch::block_min_key(key, scratch);
    if (threadIdx.x == 0) write_pair(key, vals, mask, out);
}

}  // namespace

// Lanes per CTA of the first pass; the wrapper sizes `partial` from it.
extern "C" int repro_masked_argmin_chunk() { return CHUNK; }

// vals (b, n) f32, mask (b, n) bool as bytes, n >= 1, 1 <= b <= 65,535 (b = 1
// for one vector).  out is (b, 2) int64: out[z][0] = lane z's argmin index,
// the low 4 bytes of out[z][1] = its min value (f32).  partial holds
// b ceil(n / CHUNK) keys of scratch when n > CHUNK (else unused).
extern "C" int repro_masked_argmin(const float* vals, const unsigned char* mask,
                                   int b, int n, unsigned long long* partial,
                                   long long* out, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (b < 1 || b > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const int nblocks = (n + CHUNK - 1) / CHUNK;
    masked_argmin_kernel<<<dim3(nblocks, b), THREADS, 0, s>>>(vals, mask, n,
                                                              partial, out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || nblocks == 1) return static_cast<int>(err);
    reduce_partials_kernel<<<b, THREADS, 0, s>>>(partial, nblocks, vals, mask,
                                                 n, out);
    return static_cast<int>(cudaGetLastError());
}
