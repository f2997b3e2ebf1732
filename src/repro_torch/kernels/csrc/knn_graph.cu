// k nearest candidates of every query, CUDA C++ for sm_90a: the kNN graph of
// the approx rung.
//
// Replaces: src/repro/kernels/knn_graph.py::knn_graph_pallas (the TPU
// kernel, pallas_call at :164; its running top-k fold is _fold_topk, :65),
// and with repro_knn_topk_batch knn_graph_pallas_batch (:187, pallas_call at
// :211), the same fold per lane of a (b, n, d) stack.
// In query/candidate form it also does the work of the reference's per-cell
// _cell_topk (src/repro/core/approx_mst.py:354) and of the anchored
// assignment's pairwise tiles + lax.top_k (approx_mst.py:424);
// repro_knn_topk_segmented runs every anchored cell in one launch.
//
// For each query row i and candidate column j the kernel computes the
// gram-form dissimilarity of the metric (always gram, as the reference
// does, knn_graph.py:92-95), masks a candidate with cid[j] < 0 or
// cid[j] == qid[i], and keeps the k smallest, ascending by (value,
// candidate id): the lower id wins a tie.  A slot that no valid candidate
// fills holds (+inf, -1).  The exact kNN graph is the call with
// Xq = Xc = X and qid = cid = 0..n-1.
//
// What bounds it on the H100: operations.  At the top of the exact-kNN
// window (n = 32,768, d = 64, k = 15) the function needs each pair once, one
// triangle of the (symmetric) matrix: 2 * d * n (n - 1) / 2 = 6.9e10 f32
// flops, 1.03 ms at 67 TFLOP/s.  Its bytes are negligible: X is 8 MiB and
// the output n * k * 12 B = 5.9 MB, together 4.2 us at 3.35 TB/s.  The
// anchored search of a million points at d = 8 (1,000 cells; 2.74e9 query x
// candidate pairs in the cells, 1e9 in the assignment) needs 6.0e10 flops,
// 0.89 ms; there each pair's epilogue (finish, mask, key compare) costs
// about as much as its eight FMAs.  This kernel computes both triangles
// (2 * d * n^2 flops, twice the bound): one triangle of tiles would need
// each tile's mirrored half merged into lists that other CTAs own.  TF32
// and the tensor cores are ruled out, as for every kernel of the port:
// numerics/condition.py derives KAPPA_SAFE from the f32 epsilon.
//
// Design: the TPU kernel keeps a (BM, k) best slab resident while its grid's
// last axis sweeps the column tiles in order, and gets the lower-index tie
// rule from that order.  On Hopper blocks run in no order and nothing
// carries over between them, so:
//   * one CTA of 128 threads owns BM = 128 query rows and itself loops over
//     all candidate tiles of BN = 64 columns; no merge across CTAs is needed;
//   * the tie rule comes from the key, not from the sweep order: each
//     candidate is the 64-bit key ordered_bits(value) << 32 | id
//     (argmin_key.cuh), so an unsigned compare is exactly (value, id)
//     lexicographic, and the k smallest keys are the same set whatever
//     order they arrive in: any tile order, merge order or grouping of
//     cells gives the same bits;
//   * each row keeps its k keys sorted in shared memory (BM * k * 8 B: 128
//     KiB at k = MAX_K = 128, so the launch raises the dynamic
//     shared-memory limit; every k up to MAX_K fits beside the tiles);
//   * the tile engine: each thread holds an 8 x 8 block of f32 accumulators
//     (rows ty + 16 i, columns tx + 8 j, so a quarter-warp's reads fall on
//     distinct banks), reads 8 float4 of queries and 32 scalars of
//     candidates per 4 features: 0.16 shared loads per FMA.  Features are
//     staged BK at a time, BK chosen by d before launch (8 for d <= 8, so
//     the default path's d = 8 takes one pass with no zero padding; 16 for
//     d <= 16; 32 above), into two buffers filled by cp.async: the next
//     chunk (of this tile or the next) is in flight while the current one
//     is multiplied.  Rows whose features are 16-byte aligned (d % 4 == 0
//     and aligned bases) take 16-byte copies, others 4-byte copies, a
//     route chosen by d before launch.  Out-of-range rows and features
//     are zero-filled by the copy; a zero feature pair is the identity of
//     every accumulation.  The feature loop is unrolled by two only: fully
//     unrolled beside the epilogue, the kernel's hot code overflowed the
//     instruction cache and ran at half the speed (measured on an H100).
//     Two CTAs share an SM, three at BK = 8 (the anchored search's d = 8),
//     where the launch bound caps the registers to let them in;
//   * each pair's features are summed in one ascending order with fmaf
//     (accumulate<KIND> of dissim.cuh), then finish<KIND>, with aux from
//     the pairwise kernel's own row-norm pre-pass, so every value the kernel
//     sees equals the pairwise_dist kernel's entry for the pair bit for bit;
//     the register block changes which thread computes a pair, not the
//     order of its FMAs;
//   * the epilogue screens every pair against its row's k-th key with a
//     few branch-free operations (for euclidean on the squared distance,
//     before the sqrt: see screen_bound); the few pairs that pass take
//     their exact key (value, id, masks) in a rolled loop, and those below
//     the k-th key are marked in a per-row 64-bit mask, their values left
//     in shared memory.  A stale threshold only lets more through, never
//     fewer;
//   * the top-k, by warps: each warp owns 32 rows and a ballot finds those
//     with marks.  For k <= 32 groups of 2 lanes (k <= 16) or 4 lanes own
//     a row each, its list in registers striped across the group, and
//     insert the row's marks one at a time (place = the group's count of
//     keys <= the candidate, the tail shifted one by a shuffle), so a warp
//     serves 16 or 8 rows at once.  For k > 32 the whole warp takes a row:
//     it gathers the m marked keys, sorts them in registers with a bitonic
//     network (32 keys one a lane, or 64 two a lane), and merges them into
//     the sorted list by ranks: a candidate's new place is its rank among
//     the candidates plus the count of list keys <= it, a list key's its
//     old place plus the count of candidates < it (binary searches), and
//     only places below k are written.  Two CTA barriers a tile when
//     d <= BK (one after the chunk lands, one before the merge);
//   * what remains (measured on an H100): both triangles; at
//     d = 8 the epilogue and the merges, not the FMAs, take most of the
//     time, since a query row of a 900-candidate anchored cell takes about
//     50 insertions and each group pass waits for its slowest row.
// Entries: repro_knn_topk (one query/candidate problem; grid ceil(nq / BM)),
// repro_knn_topk_batch (a grid (n / BM, b), lane z = blockIdx.y; points, aux
// and outputs sit at the lane's stride, the ids 0..n-1 are shared; gridDim.y
// caps a batch at 65,535 lanes) and repro_knn_topk_segmented (c independent
// problems, cell g its queries qoff[g]..qoff[g+1] against its candidates
// coff[g]..coff[g+1]; one 1-D launch, CTA b serves the cell g with
// boff[g] <= b < boff[g+1], boff the prefix sums of ceil(q_g / BM), found by
// a binary search).  Each runs the same code on its rows, so a lane's, a
// cell's or a query block's lists are the single call's bits.
#include <cuda_runtime.h>

#include "argmin_key.cuh"
#include "cp_async.cuh"
#include "dissim.cuh"

namespace {

using namespace repro_torch;  // ArgKey, pack_key, Kind, accumulate, finish,
                              // cp_async

constexpr int BM = 128;       // query rows per CTA
constexpr int BN = 64;        // candidates per tile (one bit each in a mask)
constexpr int TM = 8;         // accumulator rows per thread
constexpr int TN = 8;         // accumulator columns per thread
constexpr int TY = BM / TM;   // 16 row groups
constexpr int TX = BN / TN;   // 8 column groups
constexpr int THREADS = TY * TX;  // 128
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 4;        // keeps float4 alignment, spreads banks
constexpr int MAX_K = 128;    // the reference's MAX_PALLAS_K
constexpr int LIST_SLOTS = MAX_K / 32;  // list keys a lane holds in a merge

static_assert(BN == 64, "one 64-bit mark mask per row and tile");
static_assert(WARPS * 32 == BM, "a merge warp owns 32 rows");

// Dynamic shared memory of one CTA for k neighbours and staging depth bk:
// the two staging buffers first (16-byte aligned for cp.async), then the
// 8-byte arrays (lists, k-th keys, marks, two tiles' candidate ids, query
// ids, per-warp merge scratch), then the f32 ones (two tiles' candidate
// aux, query aux, the tile's values).
__host__ __device__ constexpr size_t staging_floats(int bk) {
    return 2 * static_cast<size_t>(BM + BN) * (bk + PAD);
}
__host__ __device__ constexpr size_t smem_bytes(int k, int bk) {
    return sizeof(float) * staging_floats(bk)
        + sizeof(ArgKey) * (static_cast<size_t>(BM) * k + BM + BM + 2 * BN
                            + BM + WARPS * BN)
        + sizeof(float) * (2 * BN + BM + static_cast<size_t>(BM) * (BN + 1));
}
static_assert(smem_bytes(MAX_K, 32) <= 232448, "over 227 KB at MAX_K");

// The f32 value packed into a key (argmin_key.cuh's ordered_bits, undone).
__device__ __forceinline__ float key_value(ArgKey key) {
    const unsigned hi = static_cast<unsigned>(key >> 32);
    return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7fffffffu) : ~hi);
}

// The screen of a pair before its exact key: with bv the value of its row's
// k-th key, screen<KIND>(acc, nx, ny, screen_bound<KIND>(bv)) is false only
// for pairs whose finish<KIND> value exceeds bv, which therefore cannot
// enter the list.  For euclidean it compares the squared distance, so the
// sqrt is taken only for pairs that pass: sqrtf is correctly rounded, so
// sqrtf(sq) <= bv implies sq <= (next float above bv)^2, rounded up.
template <int KIND>
__device__ __forceinline__ float screen_bound(float bv) {
    if (KIND != GRAM_EUCLIDEAN) return bv;
    const double up = nextafterf(bv, __int_as_float(0x7f800000));
    return __double2float_ru(up * up);
}
template <int KIND>
__device__ __forceinline__ bool screen(float acc, float nx, float ny,
                                       float bound) {
    if (KIND == GRAM_SQEUCLIDEAN || KIND == GRAM_EUCLIDEAN)
        return fmaxf(fmaf(-2.0f, acc, nx + ny), 0.0f) <= bound;
    if (KIND == MANHATTAN) return acc <= bound;
    return bound >= 0.0f;   // cosine: its division is the finish itself
}

// One problem's pointers and sizes, as a CTA sees them.
struct Problem {
    const float* Xq;
    const float* Xc;
    const float* aq;   // null for manhattan
    const float* ac;
    const long long* qid;
    const long long* cid;
    float* out_d;
    long long* out_i;
    int nq, nc, row0;
};

// Rows [row0, row0 + BM) x features [k0, k0 + BK) of X (n, d) into a staging
// buffer laid out [BM][BK + PAD] (rows = BM or BN).
template <int BK, int ROWS>
__device__ __forceinline__ void stage(float* buf, const float* X, int n,
                                      int d, int row0, int k0, bool vec) {
    constexpr int LD = BK + PAD;
    if (vec) {
        for (int e = threadIdx.x; e < ROWS * (BK / 4); e += THREADS) {
            const int p = e / (BK / 4);
            const int f = (e % (BK / 4)) * 4;
            const int g = row0 + p;
            const bool ok = g < n && k0 + f < d;   // d % 4 == 0: all or none
            cp_async<16>(buf + p * LD + f,
                         ok ? X + static_cast<size_t>(g) * d + k0 + f : X,
                         ok ? 16 : 0);
        }
    } else {
        for (int e = threadIdx.x; e < ROWS * BK; e += THREADS) {
            const int p = e / BK;
            const int f = e % BK;
            const int g = row0 + p;
            const bool ok = g < n && k0 + f < d;
            cp_async<4>(buf + p * LD + f,
                        ok ? X + static_cast<size_t>(g) * d + k0 + f : X,
                        ok ? 4 : 0);
        }
    }
}

// Bitonic sort, ascending, of one key a lane (32 keys).
__device__ __forceinline__ ArgKey warp_sort32(ArgKey x, int lane) {
#pragma unroll
    for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            const ArgKey y = __shfl_xor_sync(0xffffffffu, x, stride);
            const bool up = (lane & size) == 0;
            const bool lower = (lane & stride) == 0;
            x = (lower == up) ? (y < x ? y : x) : (y < x ? x : y);
        }
    }
    return x;
}

// Bitonic sort, ascending, of two keys a lane (64 keys: x0 is element lane,
// x1 element lane + 32).
__device__ __forceinline__ void warp_sort64(ArgKey& x0, ArgKey& x1,
                                            int lane) {
#pragma unroll
    for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            if (stride == 32) {   // the partner is this lane's other key
                const ArgKey lo = x1 < x0 ? x1 : x0;
                x1 = x1 < x0 ? x0 : x1;
                x0 = lo;
                continue;
            }
            const bool lower = (lane & stride) == 0;
            const ArgKey y0 = __shfl_xor_sync(0xffffffffu, x0, stride);
            const ArgKey y1 = __shfl_xor_sync(0xffffffffu, x1, stride);
            const bool up0 = (lane & size) == 0;
            const bool up1 = ((lane + 32) & size) == 0;
            x0 = (lower == up0) ? (y0 < x0 ? y0 : x0) : (y0 < x0 ? x0 : y0);
            x1 = (lower == up1) ? (y1 < x1 ? y1 : x1) : (y1 < x1 ? x1 : y1);
        }
    }
}

// Count of a[0..n) (ascending) below x, or at most x when INCLUSIVE.
template <bool INCLUSIVE>
__device__ __forceinline__ int rank_in(const ArgKey* a, int n, ArgKey x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const bool below = INCLUSIVE ? a[mid] <= x : a[mid] < x;
        if (below) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// For k <= 32 a group of G lanes owns a row and inserts its marked
// candidates one at a time, so a warp serves 32 / G rows at once (G = 2
// for k <= 16, 4 for k <= 32; S = 8 keys a lane).  The group holds the
// row's list in registers, striped S keys a lane (position g * S + s in
// lane g of the group); a candidate's place is the group's count of keys
// <= it (log2 G shuffles), and the keys behind it move up one (one shuffle
// across lanes).  The next candidate's key is read while one goes in.
template <int G, int S>
__device__ __forceinline__ void insert_group(ArgKey* list, int k,
                                             unsigned long long mk,
                                             const float* vals,
                                             const long long* ids,
                                             ArgKey* kth_row, int lane) {
    const int g = lane % G;
    ArgKey key[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int p = g * S + s;
        key[s] = (list != nullptr && p < k) ? list[p] : kMaxKey;
    }
    auto next = [&](bool& active, ArgKey& x) {
        active = mk != 0ull;
        const int c = active ? __ffsll(static_cast<long long>(mk)) - 1 : 0;
        mk &= mk - 1;
        x = active ? pack_key(vals[c], static_cast<unsigned>(ids[c]))
                   : kMaxKey;
    };
    bool active;
    ArgKey x;
    next(active, x);
    while (__any_sync(0xffffffffu, active)) {
        bool active_next;
        ArgKey x_next;
        next(active_next, x_next);
        int place = 0;
#pragma unroll
        for (int s = 0; s < S; ++s) place += key[s] <= x;
#pragma unroll
        for (int off = 1; off < G; off <<= 1)
            place += __shfl_xor_sync(0xffffffffu, place, off, G);
        const ArgKey prev = __shfl_up_sync(0xffffffffu, key[S - 1], 1, G);
        if (active) {
#pragma unroll
            for (int s = S - 1; s >= 0; --s) {
                const int p = g * S + s;
                const ArgKey below = s > 0 ? key[s - 1] : prev;
                key[s] = p < place ? key[s] : (p == place ? x : below);
            }
        }
        active = active_next;
        x = x_next;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const int p = g * S + s;
        if (list != nullptr && p < k) list[p] = key[s];
        if (list != nullptr && p == k - 1) *kth_row = key[s];
    }
}

// One warp's rows with marks (bits of `todo`), 32 / G at a time; lane r
// holds row r's mark mask in mk_lane.
template <int G>
__device__ __forceinline__ void insert_rows(unsigned todo,
                                            unsigned long long mk_lane,
                                            ArgKey* best, ArgKey* kth,
                                            const float* vals,
                                            const long long* ids, int k,
                                            int warp, int lane) {
    while (todo) {
        unsigned t = todo;   // this lane's group takes the q-th row
        for (int q = 0; q < lane / G; ++q) t &= t - 1;
        const int r = t ? __ffs(t) - 1 : 0;
        const unsigned long long mk = __shfl_sync(0xffffffffu, mk_lane, r);
        const int rl = warp * 32 + r;
        insert_group<G, 8>(t ? best + static_cast<size_t>(rl) * k : nullptr,
                           k, t ? mk : 0ull, vals + rl * (BN + 1), ids,
                           kth + rl, lane);
        for (int q = 0; q < 32 / G && todo; ++q) todo &= todo - 1;
    }
}

// Merge one row's marked candidates into its sorted list of k keys, by one
// warp (see the opening note).  scratch holds BN keys of this warp.
__device__ __forceinline__ void merge_row(ArgKey* list, int k,
                                          unsigned long long mk,
                                          const float* vals,
                                          const long long* ids,
                                          ArgKey* scratch, int lane) {
    const unsigned lo = static_cast<unsigned>(mk);
    const unsigned hi = static_cast<unsigned>(mk >> 32);
    const unsigned below = (1u << lane) - 1u;
    const int nlo = __popc(lo);
    const int m = nlo + __popc(hi);
    if ((lo >> lane) & 1u)
        scratch[__popc(lo & below)] =
            pack_key(vals[lane], static_cast<unsigned>(ids[lane]));
    if ((hi >> lane) & 1u)
        scratch[nlo + __popc(hi & below)] =
            pack_key(vals[lane + 32], static_cast<unsigned>(ids[lane + 32]));
    __syncwarp();
    ArgKey x0 = lane < m ? scratch[lane] : kMaxKey;
    ArgKey x1 = lane + 32 < m ? scratch[lane + 32] : kMaxKey;
    if (m > 32)
        warp_sort64(x0, x1, lane);
    else if (m > 1)
        x0 = warp_sort32(x0, lane);
    __syncwarp();
    scratch[lane] = x0;
    scratch[lane + 32] = x1;
    __syncwarp();
    // New places: read everything first, then write.
    ArgKey lv[LIST_SLOTS];
    int lp[LIST_SLOTS];
#pragma unroll
    for (int i = 0; i < LIST_SLOTS; ++i) {
        const int p = lane + 32 * i;
        lv[i] = p < k ? list[p] : kMaxKey;
        lp[i] = p < k ? p + rank_in<false>(scratch, m, lv[i]) : k;
    }
    const int c0 = lane < m ? lane + rank_in<true>(list, k, x0) : k;
    const int c1 = lane + 32 < m ? lane + 32 + rank_in<true>(list, k, x1) : k;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < LIST_SLOTS; ++i)
        if (lp[i] < k) list[lp[i]] = lv[i];
    if (c0 < k) list[c0] = x0;
    if (c1 < k) list[c1] = x1;
    __syncwarp();
}

// Three CTAs an SM fit in shared memory at BK = 8 and k <= 32 (two at larger
// BK); the bound caps registers so that they fit in the register file too.
template <int KIND, int BK>
__global__ void __launch_bounds__(THREADS, BK == 8 ? 3 : 2)
knn_topk_kernel(Problem P, const long long* __restrict__ qoff,
                const long long* __restrict__ coff,
                const int* __restrict__ boff, int nseg, int d, int k,
                bool vec) {
    constexpr int LD = BK + PAD;
    extern __shared__ __align__(16) unsigned char smem[];
    float* stage_buf = reinterpret_cast<float*>(smem);
    ArgKey* best = reinterpret_cast<ArgKey*>(stage_buf + staging_floats(BK));
    ArgKey* kth = best + static_cast<size_t>(BM) * k;        // [BM]
    unsigned long long* marks = kth + BM;                     // [BM]
    long long* ids = reinterpret_cast<long long*>(marks + BM);  // [2][BN]
    long long* qids = ids + 2 * BN;                           // [BM]
    ArgKey* wscratch = reinterpret_cast<ArgKey*>(qids + BM);  // [WARPS][BN]
    float* caux = reinterpret_cast<float*>(wscratch + WARPS * BN);  // [2][BN]
    float* qaux = caux + 2 * BN;                              // [BM]
    float* vals = qaux + BM;                                  // [BM][BN + 1]

    // This CTA's problem: a lane of a batch, a cell of a segmented call, or
    // the one problem.
    if (boff != nullptr) {
        int lo = 0, hi = nseg;   // the last g with boff[g] <= blockIdx.x
        while (hi - lo > 1) {
            const int mid = (lo + hi) >> 1;
            if (boff[mid] <= static_cast<int>(blockIdx.x)) lo = mid;
            else hi = mid;
        }
        const long long q0 = qoff[lo];
        const long long c0 = coff[lo];
        P.nq = static_cast<int>(qoff[lo + 1] - q0);
        P.nc = static_cast<int>(coff[lo + 1] - c0);
        P.row0 = (blockIdx.x - boff[lo]) * BM;
        P.Xq += q0 * d;
        P.Xc += c0 * d;
        if (P.aq != nullptr) { P.aq += q0; P.ac += c0; }
        P.qid += q0;
        P.cid += c0;
        P.out_d += q0 * k;
        P.out_i += q0 * k;
    } else {
        const size_t lane = blockIdx.y;
        P.Xq += lane * P.nq * d;
        P.Xc += lane * P.nc * d;
        if (P.aq != nullptr) { P.aq += lane * P.nq; P.ac += lane * P.nc; }
        P.out_d += lane * P.nq * k;
        P.out_i += lane * P.nq * k;
        P.row0 = blockIdx.x * BM;
    }
    const int nq = P.nq, nc = P.nc, row0 = P.row0;
    const int tx = threadIdx.x % TX;
    const int ty = threadIdx.x / TX;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;

    for (int e = threadIdx.x; e < BM * k; e += THREADS) best[e] = kMaxKey;
    for (int r = threadIdx.x; r < BM; r += THREADS) {
        kth[r] = kMaxKey;
        marks[r] = 0ull;
        const int g = row0 + r;
        qids[r] = g < nq ? P.qid[g] : 0;
        qaux[r] = (P.aq != nullptr && g < nq) ? P.aq[g] : 0.0f;
    }

    const int nchunks = (d + BK - 1) / BK;
    const int ntiles = (nc + BN - 1) / BN;
    const int total = ntiles * nchunks;
    auto stage_chunk = [&](int g) {
        if (g < total) {
            const int tile = g / nchunks;
            const int k0 = (g % nchunks) * BK;
            float* xs = stage_buf + (g & 1) * (BM + BN) * LD;
            stage<BK, BM>(xs, P.Xq, nq, d, row0, k0, vec);
            stage<BK, BN>(xs + BM * LD, P.Xc, nc, d, tile * BN, k0, vec);
        }
        cp_async_commit();
    };
    stage_chunk(0);

    float acc[TM][TN];
    for (int g = 0; g < total; ++g) {
        const int tile = g / nchunks;
        const int chunk = g % nchunks;
        const int col0 = tile * BN;
        const int tb = tile & 1;
        if (chunk == 0) {
            for (int c = threadIdx.x; c < BN; c += THREADS) {
                const int gc = col0 + c;
                ids[tb * BN + c] = gc < nc ? P.cid[gc] : -1;
                caux[tb * BN + c] = (P.ac != nullptr && gc < nc) ? P.ac[gc]
                                                                 : 0.0f;
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
        }
        stage_chunk(g + 1);
        cp_async_wait_one();
        __syncthreads();
        const float* xs = stage_buf + (g & 1) * (BM + BN) * LD;
        const float* ys = xs + BM * LD;
#pragma unroll 2
        for (int f = 0; f < BK; f += 4) {
            float4 a[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i)
                a[i] = *reinterpret_cast<const float4*>(
                    xs + (ty + TY * i) * LD + f);
#pragma unroll
            for (int ff = 0; ff < 4; ++ff) {
                float b[TN];
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    b[j] = ys[(tx + TX * j) * LD + f + ff];
#pragma unroll
                for (int i = 0; i < TM; ++i) {
                    const float av = ff == 0 ? a[i].x : ff == 1 ? a[i].y
                                   : ff == 2 ? a[i].z : a[i].w;
#pragma unroll
                    for (int j = 0; j < TN; ++j)
                        acc[i][j] = accumulate<KIND>(acc[i][j], av, b[j]);
                }
            }
        }
        if (chunk + 1 < nchunks) {
            __syncthreads();   // the buffer is refilled two chunks on
            continue;
        }

        // Mark the candidates below their row's k-th key.  The screen is
        // branch-free: a pair that may reach its row's list leaves its
        // accumulator in vals and a bit in `pass`; the exact keys of those
        // few are taken in a rolled loop.  (Unrolled, the exact path of all
        // 64 pairs would make the loop body far larger than the
        // instruction cache.)
        float cx[TN];
#pragma unroll
        for (int j = 0; j < TN; ++j) cx[j] = caux[tb * BN + tx + TX * j];
        unsigned long long pass = 0ull;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int rl = ty + TY * i;
            const ArgKey bar = kth[rl];
            const float bv = bar == kMaxKey ? __int_as_float(0x7f800000)
                                            : key_value(bar);
            const float bound = row0 + rl < nq ? screen_bound<KIND>(bv)
                                               : -__int_as_float(0x7f800000);
            const float arow = qaux[rl];
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const bool p = screen<KIND>(acc[i][j], arow, cx[j], bound);
                if (p) vals[rl * (BN + 1) + tx + TX * j] = acc[i][j];
                pass |= static_cast<unsigned long long>(p) << (i * TN + j);
            }
        }
        // Four passing pairs at a time, so their loads and keys overlap;
        // bits come in ascending order, so a row's marks are contiguous.
        int cur = -1;
        unsigned long long mine = 0ull;
        while (pass) {
            int bit[4];
            float v[4];
            ArgKey key[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                bit[u] = pass ? __ffsll(static_cast<long long>(pass)) - 1
                              : -1;
                pass &= pass - 1;
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                key[u] = kMaxKey;
                if (bit[u] < 0) continue;
                const int rl = ty + TY * (bit[u] / TN);
                const int cl = tx + TX * (bit[u] % TN);
                v[u] = finish<KIND>(vals[rl * (BN + 1) + cl], qaux[rl],
                                    caux[tb * BN + cl]);
                const long long id = ids[tb * BN + cl];
                if (col0 + cl < nc && id >= 0 && id != qids[rl])
                    key[u] = pack_key(v[u], static_cast<unsigned>(id));
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                if (bit[u] < 0) continue;
                const int rl = ty + TY * (bit[u] / TN);
                const int cl = tx + TX * (bit[u] % TN);
                if (rl != cur) {
                    if (mine) atomicOr(&marks[cur], mine);
                    mine = 0ull;
                    cur = rl;
                }
                if (key[u] < kth[rl]) {
                    vals[rl * (BN + 1) + cl] = v[u];
                    mine |= 1ull << cl;
                }
            }
        }
        if (mine) atomicOr(&marks[cur], mine);
        __syncthreads();

        // Each warp merges the marked candidates of its 32 rows; a ballot
        // finds the rows with marks.  For k > 32 the whole warp sorts and
        // merges them row by row; for k <= 32 lane groups insert them, 32 / G
        // rows at a time.
        {
            const int rw = warp * 32 + lane;
            const unsigned long long mk_lane = marks[rw];
            unsigned todo = __ballot_sync(0xffffffffu, mk_lane != 0ull);
            while (k > 32 && todo) {
                const int r = __ffs(todo) - 1;
                todo &= todo - 1;
                const int rl = warp * 32 + r;
                ArgKey* list = best + static_cast<size_t>(rl) * k;
                merge_row(list, k, __shfl_sync(0xffffffffu, mk_lane, r),
                          vals + rl * (BN + 1), ids + tb * BN,
                          wscratch + warp * BN, lane);
                if (lane == 0) kth[rl] = list[k - 1];
            }
            if (k <= 16)
                insert_rows<2>(todo, mk_lane, best, kth, vals, ids + tb * BN,
                               k, warp, lane);
            else if (k <= 32)
                insert_rows<4>(todo, mk_lane, best, kth, vals, ids + tb * BN,
                               k, warp, lane);
            if (mk_lane) marks[rw] = 0ull;
        }
        // The next tile's chunk barrier orders these merges before its
        // marks; its ids go to the other half of ids / caux.
    }
    __syncthreads();

    // Lists out, row-major (nq, k); an empty slot is (+inf, -1).
    for (int e = threadIdx.x; e < BM * k; e += THREADS) {
        const int r = row0 + e / k;
        if (r >= nq) continue;
        const ArgKey key = best[e];
        const size_t o = static_cast<size_t>(row0) * k + e;
        if (key == kMaxKey) {
            P.out_d[o] = __int_as_float(0x7f800000);
            P.out_i[o] = -1;
        } else {
            P.out_d[o] = key_value(key);
            P.out_i[o] = static_cast<long long>(key_index(key));
        }
    }
}

template <int KIND, int BK>
cudaError_t launch(const Problem& P, const long long* qoff,
                   const long long* coff, const int* boff, int nseg,
                   dim3 grid, int d, int k, bool vec, cudaStream_t stream) {
    const size_t smem = smem_bytes(k, BK);
    cudaError_t err = cudaFuncSetAttribute(
        knn_topk_kernel<KIND, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    knn_topk_kernel<KIND, BK><<<grid, THREADS, smem, stream>>>(
        P, qoff, coff, boff, nseg, d, k, vec);
    return cudaGetLastError();
}

template <int KIND>
cudaError_t launch_bk(const Problem& P, const long long* qoff,
                      const long long* coff, const int* boff, int nseg,
                      dim3 grid, int d, int k, bool vec, cudaStream_t s) {
    if (d <= 8) return launch<KIND, 8>(P, qoff, coff, boff, nseg, grid, d, k, vec, s);
    if (d <= 16) return launch<KIND, 16>(P, qoff, coff, boff, nseg, grid, d, k, vec, s);
    return launch<KIND, 32>(P, qoff, coff, boff, nseg, grid, d, k, vec, s);
}

int dispatch(const Problem& P, const long long* qoff, const long long* coff,
             const int* boff, int nseg, dim3 grid, int d, int k, int kind,
             cudaStream_t s) {
    if (k < 1 || k > MAX_K || d < 1 || grid.x < 1 || grid.y < 1
            || grid.y > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = rows_are_vec4(P.Xq, d) && rows_are_vec4(P.Xc, d);
    cudaError_t err;
    switch (kind) {
        case GRAM_SQEUCLIDEAN:
            err = launch_bk<GRAM_SQEUCLIDEAN>(P, qoff, coff, boff, nseg, grid, d, k, vec, s);
            break;
        case GRAM_EUCLIDEAN:
            err = launch_bk<GRAM_EUCLIDEAN>(P, qoff, coff, boff, nseg, grid, d, k, vec, s);
            break;
        case COSINE:
            err = launch_bk<COSINE>(P, qoff, coff, boff, nseg, grid, d, k, vec, s);
            break;
        case MANHATTAN:
            err = launch_bk<MANHATTAN>(P, qoff, coff, boff, nseg, grid, d, k, vec, s);
            break;
        default:
            err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}

}  // namespace

// The largest k the kernel takes, and the query rows of one CTA (a segmented
// call's work list counts ceil(q_g / BM) CTAs a cell); the wrapper reads
// both once.
extern "C" int repro_knn_max_k() { return MAX_K; }
extern "C" int repro_knn_block_rows() { return BM; }

// Xq (nq, d) and Xc (nc, d) f32 row-major; aq (nq,) and ac (nc,) their aux
// (squared row norms for the gram euclidean kinds, norms for cosine, null
// for manhattan); qid (nq,) and cid (nc,) int64 ids, each id below 2^32 or
// negative; 1 <= k <= MAX_K.  out_d (nq, k) f32 and out_i (nq, k) int64.
// kind is a gram kind of dissim.cuh: 0, 1, 2 or 5.  Returns the first CUDA
// error of the launch (cudaErrorInvalidValue for a kind or k it refuses).
extern "C" int repro_knn_topk(const float* Xq, const float* Xc,
                              const float* aq, const float* ac,
                              const long long* qid, const long long* cid,
                              int nq, int nc, int d, int k, int kind,
                              float* out_d, long long* out_i, void* stream) {
    if (nq < 1 || nc < 1) return static_cast<int>(cudaErrorInvalidValue);
    const Problem P{Xq, Xc, aq, ac, qid, cid, out_d, out_i, nq, nc, 0};
    return dispatch(P, nullptr, nullptr, nullptr, 0,
                    dim3((nq + BM - 1) / BM, 1), d, k, kind,
                    static_cast<cudaStream_t>(stream));
}

// The batch: X (b, n, d) f32, aux (b, n) (null for manhattan), ids (n,) int64
// = 0..n-1, each lane's graph over its own points; out_d (b, n, k) f32 and
// out_i (b, n, k) int64, lane-local ids.  1 <= b <= 65,535, 1 <= k <= MAX_K.
extern "C" int repro_knn_topk_batch(const float* X, const float* aux,
                                    const long long* ids, int b, int n, int d,
                                    int k, int kind, float* out_d,
                                    long long* out_i, void* stream) {
    if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
    const Problem P{X, X, aux, aux, ids, ids, out_d, out_i, n, n, 0};
    return dispatch(P, nullptr, nullptr, nullptr, 0,
                    dim3((n + BM - 1) / BM, b), d, k, kind,
                    static_cast<cudaStream_t>(stream));
}

// The segmented form: c cells, cell g its queries Xq[qoff[g]:qoff[g+1]]
// (ids qid, aux aq) against its candidates Xc[coff[g]:coff[g+1]] (ids cid,
// aux ac); qoff, coff (c + 1,) int64 device offsets from 0; boff (c + 1,)
// int32 device prefix sums of ceil(q_g / BM) with nblocks = boff[c] >= 1.
// out_d (qoff[c], k) f32 and out_i (qoff[c], k) int64, row i the list of
// query i; a cell with no candidates, or fewer valid ones than k, leaves
// (+inf, -1) in the slots it cannot fill.
extern "C" int repro_knn_topk_segmented(
        const float* Xq, const float* Xc, const float* aq, const float* ac,
        const long long* qid, const long long* cid, const long long* qoff,
        const long long* coff, const int* boff, int c, int nblocks, int d,
        int k, int kind, float* out_d, long long* out_i, void* stream) {
    if (c < 1 || nblocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    const Problem P{Xq, Xc, aq, ac, qid, cid, out_d, out_i, 0, 0, 0};
    return dispatch(P, qoff, coff, boff, c, dim3(nblocks, 1), d, k, kind,
                    static_cast<cudaStream_t>(stream));
}
