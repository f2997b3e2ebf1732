// Masked first-index argmin: (min over lanes where mask is false, its index),
// and the whole `vat` Prim ordering of a matrix in one launch.
//
// Replaces: src/repro/kernels/prim_update.py::masked_argmin_pallas (the TPU
// kernel _block_argmin_kernel plus the cross-block argmin its wrapper ran),
// also as the reference vmaps it over a batch (core/vat.py::vat_batch).
// The reference's Prim ordering (core/vat.py::vat_order, a lax.fori_loop)
// calls it once per step, n - 1 times per VAT fit; repro_vat_prim_order
// runs that whole loop, every step's argmin included, in one launch.
//
// What bounds it on the H100: the work is tiny (5 bytes and one compare per
// lane: 10 KiB at n = 2,048), so one argmin is bound by launch latency and
// by the dependent round trips of a block reduction, not by bandwidth or
// arithmetic.  The Prim ordering reads each of the n - 1 pivot rows of R
// once (4 n^2 bytes: 16.8 MB at n = 2,048, 1.07 GB at 16,384), but its
// steps are serial: each needs the previous step's winner, so a step costs
// the latency of one row read from L2 or HBM plus one block reduction.
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
//
// The Prim ordering (vat_prim_order_kernel): one CTA of 1,024 threads per
// matrix, gridDim.x = b.  Thread t owns the lanes j = t, t + 1024, ...; it
// keeps their frontier (mind[j], selected[j]) and folds row q of R into
// them, reading the row as the loop's index_select does (coalesced, rows
// only, never columns).  A step is: fold the pivot's row, pack
// (selected ? +inf : mind[j], j) into a key as masked_argmin does, one
// block_min_key (two CTA barriers), the order write; nothing leaves the
// chip.  Since each thread only ever touches its own lanes, the frontier
// needs no barrier of its own.  Where the frontier lives is chosen by n
// before launch: in shared memory (5 bytes a lane) up to
// PRIM_SHARED_MAX_N = 40,960 lanes (200 KiB of the 227 KiB a CTA may
// have), in a (b, n) global scratch the wrapper allocates above that; the
// code of a step is the same in both.  Bits: the loop it replaces folds with
// torch.minimum and selects with masked_argmin.  On finite values fminf and
// ATen's minimum return equal values; they may differ only in the sign of
// a zero, min(+0.0, -0.0), and pack_key folds -0.0 onto +0.0 before any
// compare, as torch.argmin treats the two zeros as equal, so the sign of a
// stored zero never changes a later comparison or key.  NaN cannot arrive:
// admission refuses non-finite input (api/validation.py).  Lane z's order is
// the solo launch's, bit for bit: it runs the solo code at its stride.
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

namespace {

constexpr int PRIM_SHARED_MAX_N = 40960;

// Folds pivot row `row` (null: the seed row, copied as it is) into the
// lanes of this thread and returns their least packed key.
template <bool SEED>
__device__ __forceinline__ ArgKey fold_row(const float* __restrict__ row,
                                           int n, unsigned q,
                                           float* __restrict__ mind,
                                           unsigned char* __restrict__ sel) {
    const float inf = __int_as_float(0x7f800000);
    ArgKey key = repro_torch::kMaxKey;
    for (int j = threadIdx.x; j < n; j += THREADS) {
        const bool s = SEED ? j == static_cast<int>(q)
                            : (sel[j] || j == static_cast<int>(q));
        const float m = SEED ? row[j] : fminf(mind[j], row[j]);
        mind[j] = m;
        sel[j] = s;
        key = repro_torch::min_key(key, repro_torch::pack_key(s ? inf : m, j));
    }
    return key;
}

__global__ void __launch_bounds__(THREADS)
vat_prim_order_kernel(const float* __restrict__ R,
                      const long long* __restrict__ i0, int n, int shared,
                      float* __restrict__ gmind,
                      unsigned char* __restrict__ gsel,
                      long long* __restrict__ order) {
    extern __shared__ __align__(16) unsigned char frontier[];
    __shared__ ArgKey scratch[THREADS / 32];
    const size_t lane = blockIdx.x;
    const size_t nn = static_cast<size_t>(n);
    R += lane * nn * nn;
    order += lane * nn;
    float* mind = shared ? reinterpret_cast<float*>(frontier) : gmind + lane * nn;
    unsigned char* sel = shared ? frontier + 4 * nn : gsel + lane * nn;
    const unsigned first = static_cast<unsigned>(i0[lane]);
    if (threadIdx.x == 0) order[0] = first;
    ArgKey key = fold_row<true>(R + first * nn, n, first, mind, sel);
    for (int t = 1; t < n; ++t) {
        key = repro_torch::block_min_key(key, scratch);
        const unsigned q = repro_torch::key_index(key);
        if (threadIdx.x == 0) order[t] = q;
        if (t + 1 < n) key = fold_row<false>(R + q * nn, n, q, mind, sel);
    }
}

}  // namespace

// Largest n whose frontier the Prim kernel keeps in shared memory.
extern "C" int repro_vat_prim_shared_max_n() { return PRIM_SHARED_MAX_N; }

// R (b, n, n) f32 row-major (b = 1 for one matrix), finite, n >= 1; i0 (b,)
// int64 seeds; order (b, n) int64 out.  shared = 1 keeps the frontier in
// shared memory (n <= PRIM_SHARED_MAX_N), shared = 0 in gmind (b, n) f32 and
// gsel (b, n) bytes, scratch the caller allocates (unused, may be null, when
// shared = 1).  1 <= b <= 65,535.
extern "C" int repro_vat_prim_order(const float* R, const long long* i0,
                                    int b, int n, int shared, float* gmind,
                                    unsigned char* gsel, long long* order,
                                    void* stream) {
    if (b < 1 || b > 65535 || n < 1 || (shared && n > PRIM_SHARED_MAX_N)
            || (!shared && (gmind == nullptr || gsel == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = shared ? 5 * static_cast<size_t>(n) : 0;
    cudaError_t err = cudaFuncSetAttribute(
        vat_prim_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(5 * PRIM_SHARED_MAX_N));
    if (err != cudaSuccess) return static_cast<int>(err);
    vat_prim_order_kernel<<<b, THREADS, smem, static_cast<cudaStream_t>(
        stream)>>>(R, i0, n, shared, gmind, gsel, order);
    return static_cast<int>(cudaGetLastError());
}
