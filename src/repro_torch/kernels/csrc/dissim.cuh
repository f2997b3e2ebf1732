// The one per-pair dissimilarity every kernel of the port computes.
//
// Replaces: the shared tile formula of the TPU kernels,
// src/repro/kernels/prim_stream.py::_tile_pivot_row, which both TPU Prim
// engines call so that their rows agree bit for bit
// (src/repro/kernels/prim_persist.py:244), and the tile math of
// src/repro/kernels/pairwise_dist.py::_tile_dissim.
//
// What bounds it on the H100: nothing by itself; it is inlined into
// pairwise_dist.cu (the materialized matrix and the flashvat seed scan),
// prim_persist.cu and prim_stream.cu (the two matrix-free Prim engines).
//
// Design: an ordering from the matrix-free engines equals the `vat` rung's
// ordering on the materialized matrix bit for bit only if every kernel
// computes every entry the same way.  So all three use the code here:
//   * the features of one pair are summed in one ascending order with fmaf
//     (accumulate<KIND>); a zero feature pair is the identity of every
//     accumulation, so masked or padded features change no bit;
//   * the epilogue finish<KIND>: fmaf(-2, x.y, aux_i + aux_j) for the gram
//     forms, clipped 1 - x.y / max(|x||y|, 1e-12) for cosine;
//   * aux (squared row norms, or norms for cosine) from warp_row_norm, the
//     code behind pairwise_dist.cu's row-norm pre-pass.
// Every operation is symmetric in the pair: fmaf(x, y, a) == fmaf(y, x, a),
// (x - y)^2 == (y - x)^2, |x - y| == |y - x|, aux_i + aux_j == aux_j + aux_i,
// so R[i, j] == R[j, i] whichever operand is the pivot.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace repro_torch {

// Metric kinds, as numbered by kernels/pairwise_dist.py::_KINDS.
enum Kind {
    GRAM_SQEUCLIDEAN = 0,
    GRAM_EUCLIDEAN = 1,
    COSINE = 2,
    DIRECT_SQEUCLIDEAN = 3,
    DIRECT_EUCLIDEAN = 4,
    MANHATTAN = 5,
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

// sum_k x[k]^2 over one row, by one warp: lane-strided fmaf, then an
// xor-shuffle tree; every lane returns the sum (sqrt of it for cosine).
template <typename T>
__device__ __forceinline__ float warp_row_norm(const T* __restrict__ x, int d,
                                               int lane, int take_sqrt) {
    float s = 0.0f;
    for (int k = lane; k < d; k += 32) {
        const float v = to_f32(x[k]);
        s = fmaf(v, v, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
    return take_sqrt ? sqrtf(s) : s;
}

template <int KIND>
__device__ __forceinline__ float accumulate(float acc, float x, float y) {
    if (KIND == MANHATTAN) return acc + fabsf(x - y);
    if (KIND == DIRECT_SQEUCLIDEAN || KIND == DIRECT_EUCLIDEAN) {
        const float diff = x - y;
        return fmaf(diff, diff, acc);
    }
    return fmaf(x, y, acc);  // gram forms and cosine: the cross term
}

template <int KIND>
__device__ __forceinline__ float finish(float acc, float nx, float ny) {
    if (KIND == GRAM_SQEUCLIDEAN || KIND == GRAM_EUCLIDEAN) {
        const float sq = fmaxf(fmaf(-2.0f, acc, nx + ny), 0.0f);
        return KIND == GRAM_EUCLIDEAN ? sqrtf(sq) : sq;
    }
    if (KIND == COSINE) {
        const float denom = fmaxf(nx * ny, 1e-12f);
        return fminf(fmaxf(1.0f - acc / denom, 0.0f), 2.0f);
    }
    if (KIND == DIRECT_EUCLIDEAN) return sqrtf(acc);
    return acc;
}

// True when rows of X (n, d) f32 can be read as float4: base aligned to
// 16 bytes and d a multiple of 4.  Vector loads change no bit: the features
// are still accumulated one at a time, in ascending order.
__host__ __device__ __forceinline__ bool rows_are_vec4(const float* X, int d) {
    return (d & 3) == 0 && (reinterpret_cast<uintptr_t>(X) & 15) == 0;
}

// Dissimilarity of two f32 rows x, y of length d, with aux entries ax, ay.
template <int KIND>
__device__ __forceinline__ float pair_dissim(const float* __restrict__ x,
                                             const float* __restrict__ y,
                                             int d, bool vec4, float ax,
                                             float ay) {
    float acc = 0.0f;
    int k = 0;
    if (vec4) {
        for (; k + 4 <= d; k += 4) {
            const float4 a = *reinterpret_cast<const float4*>(x + k);
            const float4 b = *reinterpret_cast<const float4*>(y + k);
            acc = accumulate<KIND>(acc, a.x, b.x);
            acc = accumulate<KIND>(acc, a.y, b.y);
            acc = accumulate<KIND>(acc, a.z, b.z);
            acc = accumulate<KIND>(acc, a.w, b.w);
        }
    }
    for (; k < d; ++k) acc = accumulate<KIND>(acc, x[k], y[k]);
    return finish<KIND>(acc, ax, ay);
}

// pair_dissim of one row x against four rows y[0..3] at once: four
// independent accumulator chains (instruction-level parallelism) over one
// read of x.  Each pair sees exactly the operations pair_dissim does, in
// the same order, so out[i] == pair_dissim(x, y[i], ...) bit for bit.
template <int KIND>
__device__ __forceinline__ void pair_dissim4(const float* __restrict__ x,
                                             const float* const* y, int d,
                                             bool vec4, float ax,
                                             const float* ay, float* out) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int k = 0;
    if (vec4) {
        for (; k + 4 <= d; k += 4) {
            const float4 a = *reinterpret_cast<const float4*>(x + k);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float4 b = *reinterpret_cast<const float4*>(y[i] + k);
                acc[i] = accumulate<KIND>(acc[i], a.x, b.x);
                acc[i] = accumulate<KIND>(acc[i], a.y, b.y);
                acc[i] = accumulate<KIND>(acc[i], a.z, b.z);
                acc[i] = accumulate<KIND>(acc[i], a.w, b.w);
            }
        }
    }
    for (; k < d; ++k) {
        const float a = x[k];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i] = accumulate<KIND>(acc[i], a, y[i][k]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = finish<KIND>(acc[i], ax, ay[i]);
}

}  // namespace repro_torch
