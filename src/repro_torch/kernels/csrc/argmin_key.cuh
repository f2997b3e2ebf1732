// First-index (value, index) argmin on one 64-bit key.
//
// Shared by the masked-argmin and iVAT kernels (and, in later slices, the
// Prim kernels): every reduction that must pick the FIRST index among equal
// minima packs (ordered value bits << 32 | index) into one unsigned 64-bit
// key and takes the unsigned minimum.  The minimum of keys is the minimum
// value, and among equal values the lowest index, whatever order the
// threads, warps or blocks combine in.
//
// Value bits: IEEE f32 bits are made monotone as unsigned integers by
// flipping the sign bit of non-negative values and every bit of negative
// ones, so negative inputs order correctly too.  -0.0 is folded onto +0.0
// first, so the two zeros tie (as they compare equal) and the index
// decides.  NaN is not supported: callers admit only finite values
// (api/validation.py), and +inf marks excluded lanes.
#pragma once

namespace repro_torch {

typedef unsigned long long ArgKey;

constexpr ArgKey kMaxKey = ~0ull;

__device__ __forceinline__ unsigned ordered_bits(float v) {
    unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ ArgKey pack_key(float v, unsigned idx) {
    return (static_cast<ArgKey>(ordered_bits(v)) << 32) | idx;
}

__device__ __forceinline__ unsigned key_index(ArgKey key) {
    return static_cast<unsigned>(key & 0xffffffffull);
}

__device__ __forceinline__ ArgKey min_key(ArgKey a, ArgKey b) {
    return b < a ? b : a;
}

__device__ __forceinline__ ArgKey warp_min_key(ArgKey key) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        key = min_key(key, __shfl_xor_sync(0xffffffffu, key, off));
    return key;
}

// The same minimum as warp_min_key by two redux.sync instructions (sm_80
// and later): the least value bits of the warp, then the least index
// among the lanes that hold them.
__device__ __forceinline__ ArgKey warp_min_key_redux(ArgKey key) {
    const unsigned hi = static_cast<unsigned>(key >> 32);
    const unsigned m = __reduce_min_sync(0xffffffffu, hi);
    const unsigned lo = __reduce_min_sync(
        0xffffffffu, hi == m ? static_cast<unsigned>(key) : 0xffffffffu);
    return (static_cast<ArgKey>(m) << 32) | lo;
}

// Block-wide minimum of one key per thread; every thread gets the result.
// `scratch` holds one key per warp (blockDim.x is a multiple of 32, at most
// 1024).  The call begins with a __syncthreads(), so back-to-back calls may
// reuse the same scratch: every read of the previous call precedes it.
__device__ __forceinline__ ArgKey block_min_key(ArgKey key, ArgKey* scratch) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    key = warp_min_key(key);
    __syncthreads();
    if (lane == 0) scratch[warp] = key;
    __syncthreads();
    return warp_min_key(lane < nwarps ? scratch[lane] : kMaxKey);
}

}  // namespace repro_torch
