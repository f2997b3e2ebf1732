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
// the latency of one row read from L2 (n = 2,048) or HBM (n = 16,384,
// past the 50 MB L2) plus one reduction over all n lanes.  One SM cannot
// keep a row's worth of loads in flight; a cluster of SMs can.
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
// The Prim ordering (vat_prim_order_kernel<C, BULK>): one thread-block
// cluster of C CTAs per matrix (C = 1, 2, 4, 8 or 16; 16 is Hopper's
// non-portable size), b clusters for a (b, n, n) stack, launched with
// cudaLaunchKernelEx and the cluster-dimension attribute; the host picks C
// by n (kernels/prim_update.py::prim_cluster_size, from the figures of
// tools/prim_order_phases.py) and a C the device cannot hold fails the
// launch.  CTA r owns the lanes [r * slice, (r + 1) * slice), slice = ceil(n
// / C) rounded up to 32, and keeps their frontier (mind f32, selected byte:
// 5 bytes a lane) in its own shared memory, up to PRIM_SLICE_MAX = 40,960
// lanes a CTA (200 KiB of the 227 KiB), so n up to 655,360 at C = 16: every
// f32 matrix that fits the card's 80 GB (n up to about 141,000) has its
// frontier on chip.  A step: every CTA folds its slice of pivot row q, read
// by each thread's coalesced loads (PRIM_UNROLL in flight a thread) or,
// where the host asks for it (16-byte rows, one matrix past the L2), by one
// cp.async.bulk into a row buffer beside the frontier (BULK, copy_row); each
// warp packs its least (selected ? +inf : mind[j], j) key as masked_argmin
// does and stores it into its slot of every CTA of the cluster with st.async
// through distributed shared memory, completing on that CTA's mbarrier; each
// CTA waits on its own mbarrier for all the cluster's keys (no cluster-wide
// barrier a step: one cost 0.3-0.55 us a step more on an H100 80GB HBM3 at
// 700 W, tools/prim_order_phases.py), and every warp of every CTA takes the
// least of them, so all hold the same q; CTA 0 writes order[t].  Slots and
// mbarriers alternate by step parity (cluster_min_key); with C = 1 the
// exchange is one __syncthreads() a step.  Two cluster barriers a launch:
// before the first key is sent and before any CTA exits.  Nothing leaves the
// chip but the order.  Bits: the loop it replaces folds with torch.minimum
// and selects with masked_argmin.  On finite values fminf and ATen's minimum
// return equal values; they may differ only in the sign of a zero, min(+0.0,
// -0.0), and pack_key folds -0.0 onto +0.0 before any compare, as
// torch.argmin treats the two zeros as equal, so the sign of a stored zero
// never changes a later comparison or key.  Every lane keeps its global
// index in its key, so the least key of the slices' least keys is the loop's
// winner, first index on ties, whatever C is.  NaN cannot arrive: admission
// refuses non-finite input (api/validation.py).  Lane z's order is the solo
// launch's, bit for bit: its cluster runs the solo code at its stride.
#include <cooperative_groups.h>
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

namespace cg = cooperative_groups;

// Lanes one CTA's frontier holds: a cluster of C CTAs orders n <= C * this
// (kernels/prim_update.py::SLICE_MAX).
constexpr int PRIM_SLICE_MAX = 40960;
constexpr int PRIM_MAX_THREADS = 1024;
constexpr int PRIM_UNROLL = 8;          // row loads a thread has in flight

// Folds pivot row `row` (the seed row: copied as it is) into this thread's
// lanes of the CTA's slice and returns their least packed key.  `row`,
// `mind` and `sel` start at the slice's first lane `lo`; the slice holds
// `cnt` lanes.  The loads of up to PRIM_UNROLL lanes are issued before any
// is folded, so a thread waits for one row read, not one a lane.
template <bool SEED>
__device__ __forceinline__ ArgKey fold_row(const float* __restrict__ row,
                                           int lo, int cnt, unsigned q,
                                           float* __restrict__ mind,
                                           unsigned char* __restrict__ sel) {
    const float inf = __int_as_float(0x7f800000);
    ArgKey key = repro_torch::kMaxKey;
    for (int base = threadIdx.x; base < cnt;
         base += PRIM_UNROLL * blockDim.x) {
        float r[PRIM_UNROLL];
#pragma unroll
        for (int u = 0; u < PRIM_UNROLL; ++u) {
            const int i = base + u * blockDim.x;
            r[u] = i < cnt ? row[i] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < PRIM_UNROLL; ++u) {
            const int i = base + u * blockDim.x;
            if (i >= cnt) break;
            const unsigned j = static_cast<unsigned>(lo + i);
            const bool s = SEED ? j == q : (sel[i] || j == q);
            const float m = SEED ? r[u] : fminf(mind[i], r[u]);
            mind[i] = m;
            sel[i] = s;
            key = repro_torch::min_key(key,
                                       repro_torch::pack_key(s ? inf : m, j));
        }
    }
    return key;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Arrive on mbarrier `mbar` (one arrival a phase) and expect `bytes` of
// st.async stores to complete this phase.
__device__ __forceinline__ void mbar_expect(unsigned mbar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(mbar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of mbarrier `mbar` completes.  A
// step's keys arrive within microseconds; a wait of seconds means a key
// was lost, and the kernel traps rather than hang the card.
__device__ __forceinline__ void mbar_wait(unsigned mbar, unsigned parity) {
    const long long start = clock64();
    for (;;) {
        unsigned done;
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, "
            "[%1], %2;\n\tselp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
        if (done) return;
        if (clock64() - start > (1ll << 33)) __trap();
    }
}

// Store `key` into the slot at shared address `slot` of CTA `rank` of the
// cluster, completing its bytes on that CTA's mbarrier at `mbar`.
__device__ __forceinline__ void send_key(ArgKey key, unsigned slot,
                                         unsigned mbar, unsigned rank) {
    unsigned rslot, rbar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(rslot) : "r"(slot), "r"(rank));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(rbar) : "r"(mbar), "r"(rank));
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64"
                 " [%0], %1, [%2];" :: "r"(rslot), "l"(key), "r"(rbar)
                 : "memory");
}

// The least key of the whole cluster; every thread of every CTA gets it.
// Each warp reduces its keys (redux.sync) and stores the warp's key into
// slot [rank * warps + warp] of every CTA of the cluster (lane l of the
// warp into CTA l) with st.async, which completes its 8 bytes on that
// CTA's mbarrier of the step's parity; each CTA waits on its own mbarrier
// for all C * warps keys, then every warp takes the least of them.  No
// cluster-wide barrier: a CTA waits only for the keys it needs.  With
// C = 1 the exchange is the CTA's __syncthreads().
//
// Slots and mbarriers alternate by step parity, and thread 0 re-arms an
// mbarrier (expecting C * warps * 8 bytes) as soon as its phase is done.
// A CTA stores step t + 2's keys only after it received every key of
// step t + 1, and each warp of a CTA sends its step t + 1 key only after
// it read step t's slots and after thread 0 re-armed (warp 0 sends after
// the re-arm): so no key overwrites a slot still unread, and none lands
// on an mbarrier that is not armed for it.
template <int C>
__device__ __forceinline__ ArgKey cluster_min_key(ArgKey key,
                                                  ArgKey* __restrict__ slots,
                                                  unsigned mbar,
                                                  unsigned parity,
                                                  unsigned rank) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    key = repro_torch::warp_min_key_redux(key);
    if constexpr (C == 1) {
        if (lane == 0) slots[warp] = key;
        __syncthreads();
    } else {
        if (lane < C)
            send_key(key, smem_addr(slots + rank * nwarps + warp), mbar,
                     lane);
        mbar_wait(mbar, parity);
        if (threadIdx.x == 0) mbar_expect(mbar, 8u * C * nwarps);
        __syncwarp();
    }
    ArgKey k = repro_torch::kMaxKey;
    for (int i = lane; i < C * nwarps; i += 32)
        k = repro_torch::min_key(k, slots[i]);
    return repro_torch::warp_min_key_redux(k);
}

// Copies this CTA's slice of a pivot row (`cnt` floats at `row`, 16-byte
// aligned) into `buf` with one cp.async.bulk that thread 0 issues, and
// waits for it on mbarrier `mbar`; returns `buf`.  Every thread of the CTA
// read the last row out of `buf` before this step's keys were complete,
// so the copy overwrites nothing still unread.
__device__ __forceinline__ const float* copy_row(const float* row, int cnt,
                                                 float* buf, unsigned mbar,
                                                 unsigned parity) {
    if (cnt == 0) return buf;   // CTA-uniform
    if (threadIdx.x == 0) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect(mbar, 4u * cnt);
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                     "complete_tx::bytes [%0], [%1], %2, [%3];"
                     :: "r"(smem_addr(buf)), "l"(row), "r"(4 * cnt),
                        "r"(mbar) : "memory");
    }
    mbar_wait(mbar, parity);
    return buf;
}

// BULK: each pivot row's slice comes into shared memory by one bulk copy
// (copy_row) instead of each thread's own loads; n % 4 == 0 and R 16-byte
// aligned, the slice followed by a row buffer of 4 bytes a lane.
template <int C, bool BULK>
__global__ void __launch_bounds__(PRIM_MAX_THREADS)
vat_prim_order_kernel(const float* __restrict__ R,
                      const long long* __restrict__ i0, int n, int slice,
                      long long* __restrict__ order) {
    extern __shared__ __align__(16) unsigned char frontier[];
    __shared__ ArgKey slots[2][C * 32];
    // [0], [1]: the key exchange by step parity; [2]: the row copy
    __shared__ __align__(8) unsigned long long xbar[3];
    const unsigned rank = C == 1 ? 0 : cg::this_cluster().block_rank();
    const size_t lane = blockIdx.y;
    const size_t nn = static_cast<size_t>(n);
    R += lane * nn * nn;
    order += lane * nn;
    const int lo = min(n, static_cast<int>(rank) * slice);
    const int cnt = min(n, lo + slice) - lo;   // 0 for a CTA past the end
    float* mind = reinterpret_cast<float*>(frontier);
    unsigned char* sel = frontier + 4 * static_cast<size_t>(slice);
    float* rowbuf = reinterpret_cast<float*>(frontier
                                             + 5 * static_cast<size_t>(slice));
    const unsigned first = static_cast<unsigned>(i0[lane]);
    const bool writer = rank == 0 && threadIdx.x == 0;
    if (writer) order[0] = first;
    if (threadIdx.x == 0) {
        for (int p = (C > 1 ? 0 : 2); p < (BULK ? 3 : 2); ++p)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                         :: "r"(smem_addr(&xbar[p])) : "memory");
        for (int p = 0; p < (C > 1 ? 2 : 0); ++p)
            mbar_expect(smem_addr(&xbar[p]), 8u * C * (blockDim.x >> 5));
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    // every CTA of the cluster has started before any writes into another
    if constexpr (C > 1) cg::this_cluster().sync(); else __syncthreads();
    ArgKey key = fold_row<true>(R + first * nn + lo, lo, cnt, first, mind,
                                sel);
    unsigned parities = 0;   // bit p: parity of xbar[p]'s current phase
    for (int t = 1; t < n; ++t) {
        const int p = t & 1;
        key = cluster_min_key<C>(key, slots[p], smem_addr(&xbar[p]),
                                 (parities >> p) & 1u, rank);
        parities ^= 1u << p;
        const unsigned q = repro_torch::key_index(key);
        if (writer) order[t] = q;
        if (t + 1 < n) {
            const float* row = R + q * nn + lo;
            if constexpr (BULK) {
                row = copy_row(row, cnt, rowbuf, smem_addr(&xbar[2]),
                               (parities >> 2) & 1u);
                parities ^= 1u << 2;
            }
            key = fold_row<false>(row, lo, cnt, q, mind, sel);
        }
    }
    // every key sent into another CTA has landed before any CTA exits
    if constexpr (C > 1) cg::this_cluster().sync();
}

template <int C, bool BULK>
cudaLaunchConfig_t prim_config(int b, int threads, int slice,
                               cudaLaunchAttribute* attr, cudaStream_t s) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, b);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = (BULK ? 9 : 5) * static_cast<size_t>(slice);
    cfg.stream = s;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = C;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

template <int C, bool BULK>
cudaError_t prim_attributes() {
    cudaError_t err = cudaFuncSetAttribute(
        vat_prim_order_kernel<C, BULK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 5 * PRIM_SLICE_MAX);
    if (err == cudaSuccess && C > 8)
        err = cudaFuncSetAttribute(
            vat_prim_order_kernel<C, BULK>,
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return err;
}

// Clusters of C CTAs of the launch at (n, threads) that can be resident
// at once; 0 when none can.
template <int C, bool BULK>
cudaError_t prim_max_clusters(int n, int threads, int* count) {
    cudaError_t err = prim_attributes<C, BULK>();
    if (err != cudaSuccess) return err;
    const int slice = ((n + C - 1) / C + 31) / 32 * 32;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = prim_config<C, BULK>(1, threads, slice, &attr,
                                                  nullptr);
    return cudaOccupancyMaxActiveClusters(
        count, vat_prim_order_kernel<C, BULK>, &cfg);
}

template <int C>
cudaError_t prim_max_clusters_of(int n, int threads, int bulk, int* count) {
    return bulk ? prim_max_clusters<C, true>(n, threads, count)
                : prim_max_clusters<C, false>(n, threads, count);
}

template <int C, bool BULK>
cudaError_t prim_launch(const float* R, const long long* i0, int b, int n,
                        int threads, long long* order, cudaStream_t s) {
    cudaError_t err = prim_attributes<C, BULK>();
    if (err != cudaSuccess) return err;
    const int slice = ((n + C - 1) / C + 31) / 32 * 32;
    if ((BULK ? 9 : 5) * slice > 5 * PRIM_SLICE_MAX
            || (BULK && (n % 4 != 0
                         || reinterpret_cast<size_t>(R) % 16 != 0)))
        return cudaErrorInvalidValue;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = prim_config<C, BULK>(b, threads, slice, &attr,
                                                  s);
    return cudaLaunchKernelEx(&cfg, vat_prim_order_kernel<C, BULK>, R, i0, n,
                              slice, order);
}

template <int C>
cudaError_t prim_dispatch(const float* R, const long long* i0, int b, int n,
                          int threads, int bulk, long long* order,
                          cudaStream_t s) {
    return bulk ? prim_launch<C, true>(R, i0, b, n, threads, order, s)
                : prim_launch<C, false>(R, i0, b, n, threads, order, s);
}

}  // namespace

// How many clusters of `cluster` CTAs, launched as repro_vat_prim_order
// would launch them at (n, threads, bulk), the current device can hold at
// once (>= 0), or minus the cudaError_t of the query.
extern "C" int repro_vat_prim_max_clusters(int cluster, int n, int threads,
                                           int bulk) {
    if (n < 1 || threads < 32 || threads > PRIM_MAX_THREADS
            || threads % 32 != 0)
        return -static_cast<int>(cudaErrorInvalidValue);
    int count = 0;
    cudaError_t err;
    switch (cluster) {
        case 1: err = prim_max_clusters_of<1>(n, threads, bulk, &count); break;
        case 2: err = prim_max_clusters_of<2>(n, threads, bulk, &count); break;
        case 4: err = prim_max_clusters_of<4>(n, threads, bulk, &count); break;
        case 8: err = prim_max_clusters_of<8>(n, threads, bulk, &count); break;
        case 16:
            err = prim_max_clusters_of<16>(n, threads, bulk, &count);
            break;
        default: err = cudaErrorInvalidValue;
    }
    return err == cudaSuccess ? count : -static_cast<int>(err);
}

// R (b, n, n) f32 row-major (b = 1 for one matrix), finite, n >= 1; i0 (b,)
// int64 seeds; order (b, n) int64 out.  One launch of b clusters of
// `cluster` CTAs (1, 2, 4, 8 or 16; cluster c serves lane c, as blockIdx.y)
// of `threads` threads (a multiple of 32, at most 1,024); each CTA's slice,
// ceil(n / cluster) rounded up to 32 lanes, must be at most
// PRIM_SLICE_MAX.  bulk = 1 brings each row's slice in by one bulk copy:
// n % 4 == 0, R 16-byte aligned and 9 * slice <= 5 * PRIM_SLICE_MAX bytes.
// 1 <= b <= 65,535.  A cluster size the device cannot schedule fails the
// launch; nothing falls back to a smaller one.
extern "C" int repro_vat_prim_order(const float* R, const long long* i0,
                                    int b, int n, int cluster, int threads,
                                    int bulk, long long* order,
                                    void* stream) {
    if (b < 1 || b > 65535 || n < 1 || threads < 32
            || threads > PRIM_MAX_THREADS || threads % 32 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (cluster) {
        case 1:
            err = prim_dispatch<1>(R, i0, b, n, threads, bulk, order, s);
            break;
        case 2:
            err = prim_dispatch<2>(R, i0, b, n, threads, bulk, order, s);
            break;
        case 4:
            err = prim_dispatch<4>(R, i0, b, n, threads, bulk, order, s);
            break;
        case 8:
            err = prim_dispatch<8>(R, i0, b, n, threads, bulk, order, s);
            break;
        case 16:
            err = prim_dispatch<16>(R, i0, b, n, threads, bulk, order, s);
            break;
        default: err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
