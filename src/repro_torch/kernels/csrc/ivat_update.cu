// iVAT geodesic transform of a VAT-ordered matrix (Havens & Bezdek 2012).
//
// Replaces: src/repro/kernels/ivat_update.py::ivat_from_vat_pallas (the TPU
// kernel _ivat_kernel).  For r = 1 .. n-1 in order:
//   j         = first-index argmin over k < r of R*[r, k]
//   D'[r, k]  = D'[k, r] = max(R*[r, j], D'[j, k])   for k < r
//   D'[r, r]  = 0
// Only min, max and argmin: the result is bit for bit the reference's.
//
// What bounds it on the H100: each step depends on the previous one (row r
// reads row j < r, which may be the row just written), so the n - 1 steps
// run in sequence.  A step moves about 16 r bytes (row r of R*, row j of D',
// row r and column r of D'), 8 n^2 bytes over the whole recurrence, which
// one SM streams at a small fraction of the card's 3.35 TB/s; the strided
// column store (one 32-byte sector per 4-byte write) and the latency of the
// two block reductions per step come on top.  The card's bound counts the
// strict lower triangle of R* read once and D' written once.
//
// Design: the TPU kernel relied on its (b, n-1) grid running in order; a
// CUDA grid does not, so the recurrence loops inside one CTA of 1,024
// threads per matrix (a batch of b matrices is b CTAs).  Each step does a
// block-wide first-index argmin on packed (value, index) keys
// (argmin_key.cuh), whose opening __syncthreads() also makes the previous
// step's stores visible, then the max-merge with row j and the stores of
// row r and column r.  D' (4 n^2 bytes: 16 MiB at n = 2,048) lives in global
// memory, which holds it in the 50 MB L2 at that size; it cannot live in
// shared memory, so there is no cap on n.  Column store versus column read:
// writing column r keeps every read of the sequential loop contiguous
// (row r of R*, row j of D'), and stores do not stall the step, whereas
// reading column j instead would put a strided, dependent load in every
// step.  Every entry of D' is written exactly once (row r and column r for
// k < r, the diagonal at step r), so the output needs no zero fill.
#include <cuda_runtime.h>

#include "argmin_key.cuh"

namespace {

using repro_torch::ArgKey;

constexpr int THREADS = 1024;

__global__ void __launch_bounds__(THREADS)
ivat_kernel(const float* __restrict__ rstar, float* __restrict__ out, int n) {
    __shared__ ArgKey scratch[THREADS / 32];
    const size_t nn = static_cast<size_t>(n) * n;
    const float* R = rstar + blockIdx.x * nn;
    float* D = out + blockIdx.x * nn;
    if (threadIdx.x == 0) D[0] = 0.0f;
    for (int r = 1; r < n; ++r) {
        const float* Rr = R + static_cast<size_t>(r) * n;
        ArgKey key = repro_torch::kMaxKey;
        for (int k = threadIdx.x; k < r; k += THREADS)
            key = repro_torch::min_key(key, repro_torch::pack_key(Rr[k], k));
        key = repro_torch::block_min_key(key, scratch);
        const int j = static_cast<int>(repro_torch::key_index(key));
        const float dcut = Rr[j];
        const float* Dj = D + static_cast<size_t>(j) * n;
        float* Dr = D + static_cast<size_t>(r) * n;
        for (int k = threadIdx.x; k < r; k += THREADS) {
            const float v = fmaxf(dcut, Dj[k]);
            Dr[k] = v;
            D[static_cast<size_t>(k) * n + r] = v;
        }
        if (threadIdx.x == 0) Dr[r] = 0.0f;
    }
}

}  // namespace

// rstar and out are (b, n, n) f32, contiguous, n >= 1, b >= 1.
extern "C" int repro_ivat_from_vat(const float* rstar, float* out, int b,
                                   int n, void* stream) {
    ivat_kernel<<<b, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        rstar, out, n);
    return static_cast<int>(cudaGetLastError());
}
