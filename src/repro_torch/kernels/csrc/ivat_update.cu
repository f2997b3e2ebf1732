// iVAT geodesic transform of a VAT-ordered matrix (Havens & Bezdek 2012).
//
// Replaces: src/repro/kernels/ivat_update.py::ivat_from_vat_pallas (the TPU
// kernel _ivat_kernel), which runs the recurrence one grid step a row:
//   j_r       = first-index argmin over k < r of R*[r, k],  w_r = R*[r, j_r]
//   D'[r, k]  = D'[k, r] = max(w_r, D'[j_r, k])   for k < r,  D'[r, r] = 0.
//
// For any matrix the recurrence gives, by induction on r, the largest w on
// the path between a and c in the tree of edges (r, j_r), capped below by
// +0 (D'[j, j] = 0 enters at k = j).  When no i with j_r < i < r has
// w_i > w_r, for every r, that path maximum is a range maximum:
//   D'[a, c] = max(+0, w_{a+1}, ..., w_c)   for a < c.
// Every Prim order meets the condition: at step i, j_r < i <= r - 1, the
// edge (j_r, r) crossed the cut, so Prim's choice had w_i <= w_r.  Every
// caller on the port's paths passes a Prim order (vat_from_dist first).
//
// What bounds it on the H100: the strict lower triangle of R* read once
// (2 n^2 bytes) and D' written once (4 n^2 bytes): 7.5 us at n = 2,048,
// 0.48 ms at 16,384 (3.35 TB/s).  A row chain of n - 1 dependent steps
// cannot reach that on one SM (4.7 ms at 2,048 on the H100).
//
// Design: four launches from one C call (repro_ivat_from_vat), each over
// all b lanes, with no host sync between them:
//
//   1. parents_kernel: a warp a row (longest rows first), 16-byte loads,
//      the first-index argmin on packed keys (argmin_key.cuh: -0.0 ties
//      +0.0 as in the recurrence); w_r is read back with R*'s own bits.
//   2. route_kernel: one CTA a lane builds O(n) tables over the weights in
//      blocks of TILE (prefix and suffix maxima inside a block, a sparse
//      table over the block maxima), then tests every row's range
//      (j_r, r) against w_r.  A NaN weight or a range maximum that is not
//      <= w_r fails the lane.  The flag stays on the card.
//   3. range_kernel: for lanes that passed, one CTA a TILE x TILE tile of
//      the upper triangle writes the tile and its transpose.  An entry is
//      max(suffix max of the row block from a + 1, max of the whole blocks
//      between, prefix max of the column block to c): the first two are
//      per row, the last per column, so both tiles come straight from two
//      64-entry vectors in shared memory as coalesced 16-byte stores (4-byte
//      stores when n % 4 != 0), streaming (st.global.cs, evict-first: this
//      op never reads D' back, and the L2 then drains the writes faster).
//      Diagonal tiles take running maxima in shared memory.  Nothing
//      (n, n) is read; every zero is written +0.0.
//   4. serial_kernel (the serial route): the recurrence itself, one CTA of
//      1,024 threads a lane, row after row, for lanes that failed; a lane
//      that passed returns at once.  A lane takes it only when its input
//      is not in Prim order or holds a NaN weight.
//
// Bits: both routes take only min, max and argmin, so a passing lane has
// the recurrence's values exactly; zeros may differ from it only in sign.
// Scratch is O(b n): j, w, the two block tables, the sparse table and one
// flag a lane.  Indices into the (b, n, n) stacks are size_t.
#include <cuda_runtime.h>

#include "argmin_key.cuh"

namespace {

using repro_torch::ArgKey;

constexpr int SERIAL_THREADS = 1024;
constexpr int PARENT_WARPS = 8;       // rows a CTA of parents_kernel
constexpr int ROUTE_THREADS = 1024;
constexpr int TILE = 64;              // table block and output tile edge
constexpr int RANGE_THREADS = 256;
constexpr int MAX_GRID_Y = 65535;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float neg_inf() {
    return __int_as_float(0xff800000);
}

__device__ __forceinline__ float nonneg(float v) {
    return v > 0.0f ? v : 0.0f;
}

__device__ __forceinline__ ArgKey fold4(ArgKey key, float4 q, unsigned k) {
    key = repro_torch::min_key(key, repro_torch::pack_key(q.x, k));
    key = repro_torch::min_key(key, repro_torch::pack_key(q.y, k + 1));
    key = repro_torch::min_key(key, repro_torch::pack_key(q.z, k + 2));
    return repro_torch::min_key(key, repro_torch::pack_key(q.w, k + 3));
}

// Stage 1.  Grid (ceil(n / PARENT_WARPS), lanes); warp t takes row n-1-t.
__global__ void __launch_bounds__(PARENT_WARPS * 32)
parents_kernel(const float* __restrict__ rstar, int* __restrict__ jv,
               float* __restrict__ wv, int n) {
    const int lane = threadIdx.x & 31;
    const long long t = static_cast<long long>(blockIdx.x) * PARENT_WARPS
        + (threadIdx.x >> 5);
    if (t >= n) return;                       // whole warps leave together
    const int r = n - 1 - static_cast<int>(t);
    const size_t z = blockIdx.y;
    const float* Rr = rstar + (z * n + r) * static_cast<size_t>(n);
    ArgKey key = repro_torch::kMaxKey;
    // a scalar head up to a 16-byte boundary, float4 body, scalar tail
    const int head = min(r, static_cast<int>(
        ((16u - (reinterpret_cast<size_t>(Rr) & 15u)) & 15u) >> 2));
    if (lane < head) key = repro_torch::pack_key(Rr[lane], lane);
    const int nvec = (r - head) >> 2;
    const float4* V = reinterpret_cast<const float4*>(Rr + head);
    int v = lane;
    for (; v + 96 < nvec; v += 128) {         // four loads in flight a lane
        float4 q[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) q[u] = __ldcs(V + v + 32 * u);
#pragma unroll
        for (int u = 0; u < 4; ++u)
            key = fold4(key, q[u], head + 4 * (v + 32 * u));
    }
    for (; v < nvec; v += 32) key = fold4(key, __ldcs(V + v), head + 4 * v);
    for (int k = head + 4 * nvec + lane; k < r; k += 32)
        key = repro_torch::min_key(key, repro_torch::pack_key(Rr[k], k));
    key = repro_torch::warp_min_key(key);
    if (lane == 0) {
        const size_t o = z * n + r;
        if (r == 0) {
            jv[o] = 0;
            wv[o] = neg_inf();
        } else {
            const int j = static_cast<int>(repro_torch::key_index(key));
            jv[o] = j;
            wv[o] = Rr[j];
        }
    }
}

// Maximum of blocks c0..c1 (c0 <= c1) from the sparse table: level l holds
// the maximum of 2^l blocks from each start.
__device__ __forceinline__ float blocks_max(const float* sp, int nblk, int c0,
                                            int c1) {
    const int l = 31 - __clz(c1 - c0 + 1);
    return fmaxf(sp[l * nblk + c0], sp[l * nblk + c1 - (1 << l) + 1]);
}

// Stage 2.  One CTA a lane.  pre/suf/sparse are written and read here, so
// they are plain pointers (no read-only cache path).
__global__ void __launch_bounds__(ROUTE_THREADS)
route_kernel(const int* __restrict__ jv, const float* __restrict__ wv,
             float* pre, float* suf, float* sparse, int* __restrict__ flag,
             unsigned long long* routes, int n, int nblk, int levels) {
    const size_t z = blockIdx.x;
    const int* J = jv + z * n;
    const float* W = wv + z * n;
    float* P = pre + z * n;
    float* S = suf + z * n;
    float* SP = sparse + z * static_cast<size_t>(levels) * nblk;
    const int lane = threadIdx.x & 31;
    // a warp a block: prefix and suffix maxima of its two halves by shuffles
    for (int c = threadIdx.x >> 5; c < nblk; c += ROUTE_THREADS / 32) {
        const int i0 = c * TILE + lane, i1 = i0 + 32;
        float pa = i0 < n ? W[i0] : neg_inf();
        float pb = i1 < n ? W[i1] : neg_inf();
        float sa = pa, sb = pb;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float ua = __shfl_up_sync(FULL, pa, off);
            const float ub = __shfl_up_sync(FULL, pb, off);
            const float da = __shfl_down_sync(FULL, sa, off);
            const float db = __shfl_down_sync(FULL, sb, off);
            if (lane >= off) { pa = fmaxf(pa, ua); pb = fmaxf(pb, ub); }
            if (lane + off < 32) { sa = fmaxf(sa, da); sb = fmaxf(sb, db); }
        }
        const float ma = __shfl_sync(FULL, pa, 31);
        const float mb = __shfl_sync(FULL, sb, 0);
        if (i0 < n) { P[i0] = pa; S[i0] = fmaxf(sa, mb); }
        if (i1 < n) { P[i1] = fmaxf(pb, ma); S[i1] = sb; }
        if (lane == 0) SP[c] = fmaxf(ma, mb);
    }
    __syncthreads();
    for (int l = 1; l < levels; ++l) {
        const int half = 1 << (l - 1), starts = nblk - (1 << l) + 1;
        for (int c = threadIdx.x; c < starts; c += ROUTE_THREADS)
            SP[l * nblk + c] = fmaxf(SP[(l - 1) * nblk + c],
                                     SP[(l - 1) * nblk + c + half]);
        __syncthreads();
    }
    // The tables ignore NaN (fmaxf); a NaN weight fails its own row's test.
    int ok = 1;
    for (int r = threadIdx.x + 1; r < n; r += ROUTE_THREADS) {
        const float wr = W[r];
        if (wr != wr) { ok = 0; continue; }   // NaN
        const int lo = J[r] + 1, hi = r - 1;
        if (lo > hi) continue;
        const int c0 = lo / TILE, c1 = hi / TILE;
        float m;
        if (c0 == c1) {
            m = neg_inf();
            for (int i = lo; i <= hi; ++i) m = fmaxf(m, W[i]);
        } else {
            m = fmaxf(S[lo], P[hi]);
            if (c1 - c0 > 1)
                m = fmaxf(m, blocks_max(SP, nblk, c0 + 1, c1 - 1));
        }
        if (!(m <= wr)) ok = 0;
    }
    ok = __syncthreads_and(ok);
    if (threadIdx.x == 0) {
        flag[z] = ok;
        if (routes != nullptr) atomicAdd(routes + (ok ? 0 : 1), 1ull);
    }
}

// Stage 3.  Grid (nt (nt + 1) / 2 tiles of the upper triangle, lanes).
__global__ void __launch_bounds__(RANGE_THREADS)
range_kernel(const float* __restrict__ wv, const float* __restrict__ pre,
             const float* __restrict__ suf, const float* __restrict__ sparse,
             const int* __restrict__ flag, float* __restrict__ out, int n,
             int nblk, int levels) {
    const size_t z = blockIdx.y;
    if (!flag[z]) return;
    __shared__ __align__(16) float rowv[TILE];
    __shared__ __align__(16) float colv[TILE];
    __shared__ float tile[TILE][TILE + 1];
    // tile t -> (I, J), I <= J, t = J (J + 1) / 2 + I
    const long long t = blockIdx.x;
    int J = static_cast<int>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0)
                             * 0.5);
    while (static_cast<long long>(J) * (J + 1) / 2 > t) --J;
    while (static_cast<long long>(J + 1) * (J + 2) / 2 <= t) ++J;
    const int I =
        static_cast<int>(t - static_cast<long long>(J) * (J + 1) / 2);
    const size_t zn = z * n;
    float* D = out + zn * n;
    const size_t row0 = static_cast<size_t>(I) * TILE;
    const size_t col0 = static_cast<size_t>(J) * TILE;
    const int tid = threadIdx.x;
    const bool vec = (n & 3) == 0;
    if (I == J) {
        if (tid < TILE) rowv[tid] = row0 + tid < n ? wv[zn + row0 + tid]
                                                   : neg_inf();
        __syncthreads();
        if (tid < TILE) {
            float run = neg_inf();
            tile[tid][tid] = 0.0f;
            for (int c = tid + 1; c < TILE; ++c) {
                run = fmaxf(run, rowv[c]);
                tile[tid][c] = tile[c][tid] = nonneg(run);
            }
        }
        __syncthreads();
        if (vec) {
            const int c = 4 * (tid & 15);
            for (int ra = tid >> 4; ra < TILE; ra += 16)
                if (row0 + ra < n && row0 + c < n)
                    __stcs(reinterpret_cast<float4*>(D + (row0 + ra) * n
                                                     + row0 + c),
                           make_float4(tile[ra][c], tile[ra][c + 1],
                                       tile[ra][c + 2], tile[ra][c + 3]));
        } else {
            const int c = tid & 63;
            for (int ra = tid >> 6; ra < TILE; ra += 4)
                if (row0 + ra < n && row0 + c < n)
                    __stcs(D + (row0 + ra) * n + row0 + c, tile[ra][c]);
        }
        return;
    }
    // I < J: block I is whole (col0 < n), so every row a of it is < n
    const float* SP = sparse + z * static_cast<size_t>(levels) * nblk;
    if (tid < TILE) {
        float s = tid < TILE - 1 ? suf[zn + row0 + tid + 1] : neg_inf();
        if (J - I > 1) s = fmaxf(s, blocks_max(SP, nblk, I + 1, J - 1));
        rowv[tid] = s;
    } else if (tid < 2 * TILE) {
        const size_t c = col0 + tid - TILE;
        colv[tid - TILE] = c < n ? pre[zn + c] : neg_inf();
    }
    __syncthreads();
    // D'[row0 + ra, col0 + c] = max(rowv[ra], colv[c]); the transpose
    // D'[col0 + ra, row0 + c] = max(rowv[c], colv[ra])
    if (vec) {
        const int c = 4 * (tid & 15);
        const float4 rc = *reinterpret_cast<const float4*>(rowv + c);
        const float4 cc = *reinterpret_cast<const float4*>(colv + c);
#pragma unroll
        for (int k = 0; k < TILE / 16; ++k) {
            const int ra = (tid >> 4) + 16 * k;
            if (col0 + c < n) {
                const float s = rowv[ra];
                float4* dst = reinterpret_cast<float4*>(
                    D + (row0 + ra) * n + col0 + c);
                __stcs(dst, make_float4(
                    nonneg(fmaxf(s, cc.x)), nonneg(fmaxf(s, cc.y)),
                    nonneg(fmaxf(s, cc.z)), nonneg(fmaxf(s, cc.w))));
            }
            if (col0 + ra < n) {
                const float p = colv[ra];
                float4* dst = reinterpret_cast<float4*>(
                    D + (col0 + ra) * n + row0 + c);
                __stcs(dst, make_float4(
                    nonneg(fmaxf(rc.x, p)), nonneg(fmaxf(rc.y, p)),
                    nonneg(fmaxf(rc.z, p)), nonneg(fmaxf(rc.w, p))));
            }
        }
    } else {
        const int c = tid & 63;
        for (int ra = tid >> 6; ra < TILE; ra += 4) {
            if (col0 + c < n)
                __stcs(D + (row0 + ra) * n + col0 + c,
                       nonneg(fmaxf(rowv[ra], colv[c])));
            if (col0 + ra < n)
                __stcs(D + (col0 + ra) * n + row0 + c,
                       nonneg(fmaxf(rowv[c], colv[ra])));
        }
    }
}

// Stage 4, the serial route: the recurrence in one CTA a lane.  Each step
// does a block-wide first-index argmin on packed keys, whose opening
// __syncthreads() also makes the previous step's stores visible, then the
// max-merge with row j and the stores of row r and column r (writing the
// column keeps every read of the loop contiguous).  D' lives in global
// memory, so n has no cap; every entry is written exactly once.
__global__ void __launch_bounds__(SERIAL_THREADS)
serial_kernel(const float* __restrict__ rstar, const int* __restrict__ flag,
              float* __restrict__ out, int n) {
    if (flag != nullptr && flag[blockIdx.x]) return;
    __shared__ ArgKey scratch[SERIAL_THREADS / 32];
    const size_t nn = static_cast<size_t>(n) * n;
    const float* R = rstar + blockIdx.x * nn;
    float* D = out + blockIdx.x * nn;
    if (threadIdx.x == 0) D[0] = 0.0f;
    for (int r = 1; r < n; ++r) {
        const float* Rr = R + static_cast<size_t>(r) * n;
        ArgKey key = repro_torch::kMaxKey;
        for (int k = threadIdx.x; k < r; k += SERIAL_THREADS)
            key = repro_torch::min_key(key, repro_torch::pack_key(Rr[k], k));
        key = repro_torch::block_min_key(key, scratch);
        const int j = static_cast<int>(repro_torch::key_index(key));
        const float dcut = Rr[j];
        const float* Dj = D + static_cast<size_t>(j) * n;
        float* Dr = D + static_cast<size_t>(r) * n;
        for (int k = threadIdx.x; k < r; k += SERIAL_THREADS) {
            const float v = fmaxf(dcut, Dj[k]);
            Dr[k] = v;
            D[static_cast<size_t>(k) * n + r] = v;
        }
        if (threadIdx.x == 0) Dr[r] = 0.0f;
    }
}

int sparse_levels(int nblk) {
    int levels = 1;
    while ((2 << (levels - 1)) <= nblk) ++levels;
    return levels;
}

// 4-byte words of one lane's sparse table: levels x nblk.
size_t sparse_words(int n) {
    const int nblk = (n + TILE - 1) / TILE;
    return static_cast<size_t>(sparse_levels(nblk)) * nblk;
}

int launch_parents(const float* rstar, int* j, float* w, int b, int n,
                   cudaStream_t s) {
    const size_t nn = static_cast<size_t>(n) * n;
    for (int z0 = 0; z0 < b; z0 += MAX_GRID_Y) {
        const dim3 grid((n + PARENT_WARPS - 1) / PARENT_WARPS,
                        min(b - z0, MAX_GRID_Y));
        parents_kernel<<<grid, PARENT_WARPS * 32, 0, s>>>(
            rstar + z0 * nn, j + static_cast<size_t>(z0) * n,
            w + static_cast<size_t>(z0) * n, n);
    }
    return static_cast<int>(cudaGetLastError());
}

int launch_route(const int* j, const float* w, float* pre, float* suf,
                 float* sparse, int* flag, void* routes, int b, int n,
                 cudaStream_t s) {
    if (b == 0) return 0;
    const int nblk = (n + TILE - 1) / TILE;
    route_kernel<<<b, ROUTE_THREADS, 0, s>>>(
        j, w, pre, suf, sparse, flag,
        static_cast<unsigned long long*>(routes), n, nblk,
        sparse_levels(nblk));
    return static_cast<int>(cudaGetLastError());
}

int launch_range(const float* w, const float* pre, const float* suf,
                 const float* sparse, const int* flag, float* out, int b,
                 int n, cudaStream_t s) {
    const int nblk = (n + TILE - 1) / TILE;
    const long long tiles = static_cast<long long>(nblk) * (nblk + 1) / 2;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const size_t nn = static_cast<size_t>(n) * n;
    const size_t lvl = sparse_words(n);
    for (int z0 = 0; z0 < b; z0 += MAX_GRID_Y) {
        const dim3 grid(static_cast<unsigned>(tiles), min(b - z0, MAX_GRID_Y));
        const size_t o = static_cast<size_t>(z0) * n;
        range_kernel<<<grid, RANGE_THREADS, 0, s>>>(
            w + o, pre + o, suf + o, sparse + z0 * lvl, flag + z0,
            out + z0 * nn, n, nblk, sparse_levels(nblk));
    }
    return static_cast<int>(cudaGetLastError());
}

int launch_serial(const float* rstar, const int* flag, float* out, int b,
                  int n, cudaStream_t s) {
    if (b == 0) return 0;
    serial_kernel<<<b, SERIAL_THREADS, 0, s>>>(rstar, flag, out, n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 4-byte words of one lane's sparse table (the route and range stages'
// `sparse` argument holds b of them), and of the op's whole scratch.  The
// layout lives here alone: callers size their buffers from these.
extern "C" long long repro_ivat_sparse_words(int n) {
    return static_cast<long long>(sparse_words(n));
}

extern "C" long long repro_ivat_scratch_words(int b, int n) {
    return static_cast<long long>(b) * (4 * static_cast<size_t>(n)
                                        + sparse_words(n) + 1);
}

// The op: rstar and out (b, n, n) f32 contiguous, n >= 1, b >= 1; scratch
// of repro_ivat_scratch_words(b, n) 4-byte words, laid out j (b, n) i32,
// w, pre, suf (b, n) f32 each, the sparse table (b, levels, nblk) f32
// (nblk = ceil(n / TILE), levels its bit length), then flag (b,) i32;
// routes null or a (2,) int64 counter of lanes per route (range, serial),
// added to.  Four launches, no sync.
extern "C" int repro_ivat_from_vat(const float* rstar, float* out,
                                   void* scratch, void* routes, int b, int n,
                                   void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    const size_t bn = static_cast<size_t>(b) * n;
    int* j = static_cast<int*>(scratch);
    float* w = reinterpret_cast<float*>(j + bn);
    float* pre = w + bn;
    float* suf = pre + bn;
    float* sparse = suf + bn;
    int* flag = reinterpret_cast<int*>(sparse + b * sparse_words(n));
    int err = launch_parents(rstar, j, w, b, n, s);
    if (err == 0) err = launch_route(j, w, pre, suf, sparse, flag, routes, b,
                                     n, s);
    if (err == 0) err = launch_range(w, pre, suf, sparse, flag, out, b, n, s);
    if (err == 0) err = launch_serial(rstar, flag, out, b, n, s);
    return err;
}

// The stages one at a time, for holding each against its plain version:
// parents (rstar (b, n, n) -> j, w (b, n)); route (tables and flag as
// above); range (lanes whose flag is set); the serial route (flag null:
// every lane).
extern "C" int repro_ivat_parents(const float* rstar, int* j, float* w, int b,
                                  int n, void* stream) {
    return launch_parents(rstar, j, w, b, n,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int repro_ivat_route(const int* j, const float* w, float* pre,
                                float* suf, float* sparse, int* flag,
                                void* routes, int b, int n, void* stream) {
    return launch_route(j, w, pre, suf, sparse, flag, routes, b, n,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int repro_ivat_range(const float* w, const float* pre,
                                const float* suf, const float* sparse,
                                const int* flag, float* out, int b, int n,
                                void* stream) {
    return launch_range(w, pre, suf, sparse, flag, out, b, n,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int repro_ivat_serial(const float* rstar, const int* flag,
                                 float* out, int b, int n, void* stream) {
    return launch_serial(rstar, flag, out, b, n,
                         static_cast<cudaStream_t>(stream));
}
