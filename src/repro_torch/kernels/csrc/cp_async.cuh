// cp.async from global to shared memory, shared by the tile engines of
// knn_graph.cu and pairwise_dist.cu: each stages BK features of its rows a
// chunk, two buffers deep, the next chunk in flight while the current one
// is multiplied.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// cp.async of 4 or 16 bytes; src_bytes = 0 writes zeros and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async(float* smem, const float* gmem,
                                         int src_bytes) {
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(smem));
    if (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(dst), "l"(gmem), "r"(src_bytes));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(dst), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most one committed group (the chunk just issued) is in
// flight.
__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::);
}

}  // namespace repro_torch
