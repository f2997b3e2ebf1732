// The whole exact Prim (VAT) traversal of X in one launch, eager or with
// lazy tile pruning, spread over a group of CTAs: the flashvat rung's
// default ("Turbo") engine, CUDA C++ for sm_90a.
//
// Replaces: src/repro/kernels/prim_persist.py::prim_persist_pallas (the TPU
// kernel _persist_kernel).  Same outputs: the visit order, each visit's MST
// edge, and the work done.  The state, per tile T of `block` lanes:
//   mind[j]   frontier; +inf = selected, UNSEEN (FLT_MAX) = nothing folded
//   tk1[T]    the tile's least packed (value, lane) key (argmin_key.cuh) over
//             its stored, maybe stale, lanes; tk2[T] the second least
//   pend[T]   lower bound on every pivot not yet folded into tile T
//   nfold[T]  how many pivots (a prefix of order) tile T has folded
//   live[T]   its unselected lanes
// Step t (pivot q = order[t - 1]): every live tile's pend takes the bound
// of q (triangle inequality off the tile's centroid and radius, shrunk by
// margin and debited the slack), and every live tile whose bound
// min(tk1 value, pend) is <= U folds all its pending pivots order[nfold:t]
// (+inf lanes stay +inf).  U is the least stored tile minimum after the
// last winner left: the true minimum of a tile never exceeds its stored
// one, so U bounds this step's edge from above.  The tile holding U folds,
// so afterwards the least fresh key B has value <= U < every unfolded
// tile's bound <= its true minimum: B is the winner, the first lane holding
// the least value, and no second round is needed.  A stale lane is >= its
// tile's bound > B, so pruning changes no bit of order or edges, only the
// work.  prune = 0 folds every live tile every step (the eager schedule).
// Which tiles fold depends only on U and each tile's own state, never on
// how the tiles are spread over CTAs, so order, edges and stats are the
// same for every group size.  stats = [tile folds, pivot-row folds, pair
// evaluations, group barriers]; a pair evaluation is one (pivot,
// unselected lane) dissimilarity, k * live of them for a fold of k pivots.
// Every exact schedule makes exactly n (n - 1) / 2 (a lane folds every
// earlier pivot, once, before it can win), so pruning saves tile folds, not
// arithmetic.
//
// What bounds it on the H100: the bytes are X read once plus O(n) outputs
// (12.8 MB at n = 50,000, d = 64: 3.8 us at 3.35 TB/s); the operations are
// one FMA per feature and pair evaluation, 2 * d * stats[2] f32 operations
// (2.39 ms at 67 TFLOP/s at n = 50,000, d = 64).  But the recurrence is
// serial: each pivot depends on the last step's minimum over all lanes, so
// a traversal spread over G CTAs needs one group-wide exchange a step.  Its
// floor is (n - 1) exchanges of a few L2 round trips each, far above the
// operations bound; the design keeps a step at one exchange.
//
// Design: one launch of b * G CTAs of THREADS threads: a group of G CTAs
// for each of the b lanes (lane z = blockIdx.x / G).  The host picks G once
// a launch: G = max(1, C / b), C the co-resident CTAs the occupancy API
// allows times the SMs, capped by the tile count and by THREADS (one
// polling thread a slot).  G > 1 launches cooperatively, so every CTA of a
// group is resident or the launch fails; G = 1 (b >= C) launches plainly
// and the exchange is the CTA's own __syncthreads().  CTA g of a group owns
// the tiles [g * tpc, (g + 1) * tpc), tpc = ceil(nblk / G); a CTA left with
// no tile still takes part in every exchange.  When a CTA's rows fit beside
// the pivot chunk in the opt-in shared memory (and the group stays
// co-resident), it copies them there once, row stride padded so a warp's
// row reads hit distinct banks, with its frontier, aux and tile state;
// otherwise all of it stays in global memory, each piece read and written
// by its owner only.  A step in a CTA, eager: every unselected lane folds
// the last pivot and the CTA's partial is its least key (one block
// reduction).  Pruned:
//   1. warp per owned tile: pend, the fold decision, the counters;
//   2. the pending pivots (indices, aux, rows when they fit) go through
//      shared memory in chunks, and each lane of a folding tile folds them
//      four at a time (pair_dissim4);
//   3. warp per owned tile: a folded tile's two least keys; the CTA's two
//      least fresh keys and least stale minimum.
// Both then:
//   4. the exchange: thread 0 writes the CTA's slot (least fresh key F; x,
//      the second fresh value or the stale minimum; c, F's value or the
//      stale minimum) as one 16-byte store, its words tagged with the step;
//      threads 0..G-1 each spin on one slot until it holds this step's
//      tag, and the CTA reduces them: the winner is the least F, the next
//      U the least of the winner's x and the others' c.  Slots are a cache
//      line each, double-buffered by step parity, on zeroed scratch: one
//      barrier a step, and no counter to reset;
//   5. the winner's owner closes its lane, writes order[t] and edges[t]
//      (the lane's own f32 bits) and, pruned, refreshes its tile's keys;
//      every CTA fetches the new pivot's row into the chunk's first slot.
// Every pair value comes from dissim.cuh, the code every Prim engine runs,
// in the same order, so every engine sees the same bits.  The last pivot is
// carried in a register, so a fold never waits for another CTA's
// order[t - 1]; a catch-up fold reads older pivots past L1 after a fence
// that pairs with the writer's fence before its next slot (pruned only:
// eager folds never read order).  Every selection is a minimum of packed
// keys, whatever the reduction order.  Unreachable states (no fresh lane,
// a winner above U, a winner whose value is not its lane's) trap rather
// than leave order[t:] unwritten.
#include <cuda_runtime.h>

#include <algorithm>
#include <cfloat>

#include "argmin_key.cuh"
#include "dissim.cuh"

namespace {

using namespace repro_torch;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned kMaxBits = 0xffffffffu;

__device__ __forceinline__ unsigned key_bits(ArgKey k) {
    return static_cast<unsigned>(k >> 32);
}

// The two least keys of a set (keys are distinct but for kMaxKey).
struct Two {
    ArgKey a, b;
};

__device__ __forceinline__ Two two_insert(Two s, ArgKey k) {
    if (k < s.a) {
        s.b = s.a;
        s.a = k;
    } else if (k < s.b) {
        s.b = k;
    }
    return s;
}

__device__ __forceinline__ Two two_merge(Two x, Two y) {
    return {min_key(x.a, y.a),
            min_key(x.a < y.a ? y.a : x.a, min_key(x.b, y.b))};
}

__device__ __forceinline__ Two warp_two(Two s) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const Two o{__shfl_xor_sync(0xffffffffu, s.a, off),
                    __shfl_xor_sync(0xffffffffu, s.b, off)};
        s = two_merge(s, o);
    }
    return s;
}

// A CTA's partial before the exchange: its two least fresh keys and its
// least stale tile minimum (ordered bits).
struct Part {
    Two k;
    unsigned s;
};

__device__ __forceinline__ Part warp_part(Part p) {
    p.k = warp_two(p.k);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        p.s = min(p.s, __shfl_xor_sync(0xffffffffu, p.s, off));
    return p;
}

// The exchange's reduction over slots: the least F; x = the winner's x
// with every other slot's c; c = the least c seen.  Associative and, for
// distinct F, independent of the order of the merges.
struct Xc {
    ArgKey f;
    unsigned x, c;
};

__device__ __forceinline__ Xc no_slot() {
    return {kMaxKey, kMaxBits, kMaxBits};
}

__device__ __forceinline__ Xc xc_merge(Xc p, Xc q) {
    const unsigned c = min(p.c, q.c);
    return p.f <= q.f ? Xc{p.f, min(p.x, q.c), c} : Xc{q.f, min(q.x, p.c), c};
}

__device__ __forceinline__ Xc warp_xc(Xc v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const Xc o{__shfl_xor_sync(0xffffffffu, v.f, off),
                   __shfl_xor_sync(0xffffffffu, v.x, off),
                   __shfl_xor_sync(0xffffffffu, v.c, off)};
        v = xc_merge(v, o);
    }
    return v;
}

// One CTA's published slot: 16 bytes written and read whole, four words
// (F's value bits, F's index, x, c) whose top bits all carry the step's
// tag.  Each word's own top bit is known: 1 in the ordered bits of a
// value >= 0 (and of kMaxBits, which marks a CTA with no fresh lane), 0
// in an index < 2^31.  Slot
// p = t & 1 serves steps t, t + 2, ..., tagged 1, 0, 1, ... in turn, and
// zeroed scratch reads as tag 0, so a reader at step t tells this step's
// slot from an older one (or from none) even if the access were split.
struct __align__(128) Slot {
    unsigned w[4];
    unsigned pad[28];  // a cache line each: the G^2 polls spread over G lines
};

__device__ __forceinline__ unsigned step_tag(int t) {
    return ((static_cast<unsigned>(t + 1) >> 1) & 1u) << 31;
}

__device__ __forceinline__ void slot_store(Slot* s, ArgKey f, unsigned x,
                                           unsigned c, unsigned tag) {
    const unsigned lo = 0x7fffffffu;
    asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};"
                 :: "l"(s), "r"((key_bits(f) & lo) | tag),
                    "r"((key_index(f) & lo) | tag), "r"((x & lo) | tag),
                    "r"((c & lo) | tag)
                 : "memory");
}

// Spin until slot s holds step tag's words; the slot's (F, x, c).
__device__ __forceinline__ Xc slot_wait(const Slot* s, unsigned tag) {
    unsigned a, b, c, d;
    do {
        asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
                     : "=r"(a), "=r"(b), "=r"(c), "=r"(d)
                     : "l"(s)
                     : "memory");
    } while (((a ^ tag) | (b ^ tag) | (c ^ tag) | (d ^ tag)) >> 31);
    const unsigned hi = 0x80000000u;
    return {(static_cast<ArgKey>(a | hi) << 32) | (b & ~hi), c | hi, d | hi};
}

// Lower bound on the dissimilarity of pivot xq to any lane of a tile with
// centroid c and radius rad, in the metric's units (prim_persist.py's
// tile_lb), by one warp: direct-form centroid distance, L1 for manhattan,
// the features lane-strided and summed by an xor butterfly (every lane
// gets the same bits); minus the radius, times margin; the gram slack
// debited in squared units.  Cosine has rad = +inf, so its bound is 0 and
// it never prunes.
template <int KIND>
__device__ __forceinline__ float warp_tile_lb(const float* __restrict__ c,
                                              float rad, const float* xq,
                                              int d, float margin,
                                              float slack_sq, int lane) {
    float s = 0.0f;
    for (int k = lane; k < d; k += 32) {
        const float diff = c[k] - xq[k];
        s = KIND == MANHATTAN ? s + fabsf(diff) : fmaf(diff, diff, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
    const float dq = KIND == MANHATTAN ? s : sqrtf(fmaxf(s, 0.0f));
    const float e = fmaxf(dq - rad, 0.0f) * margin;
    if (KIND == GRAM_EUCLIDEAN || KIND == DIRECT_EUCLIDEAN)
        return fmaxf(e - sqrtf(slack_sq), 0.0f);
    if (KIND == GRAM_SQEUCLIDEAN || KIND == DIRECT_SQEUCLIDEAN)
        return fmaxf(e * e - slack_sq, 0.0f);
    return e;
}

struct Params {
    const float* X;       // (b, n, d)
    const float* aux;     // (b, n)
    const long long* i0;  // (b,)
    const float* cent;    // (b, nblk, d)
    const float* rad;     // (b, nblk)
    const float* slack;   // (b,)
    float* mind;          // (b, n), when the frontier is not staged
    float* pend;          // (b, nblk)
    ArgKey* tk1;          // (b, nblk)
    ArgKey* tk2;          // (b, nblk)
    int* nfold;           // (b, nblk)
    int* live;            // (b, nblk)
    int* nfrom;           // (b, nblk): this step's fold start, t = none
    Slot* slots;          // (b, 2, G), zeroed
    long long* order;     // (b, n)
    float* edges;         // (b, n)
    unsigned long long* stats;  // (b, 4), zeroed
    float margin;
    int n, d, block, nblk;
    int G, tpc;           // CTAs a lane, tiles a CTA
    int pc;               // pivots a shared-memory chunk
    int stride;           // staged row stride (floats)
    int prune;
    bool pstaged;         // the chunk's pivot rows go through shared memory
    bool staged;          // the CTA's rows and frontier live in shared memory
    bool vec4;
};

// The two least keys of tile [start, end) of the frontier, by one warp;
// every lane gets them.  mind is indexed from the CTA's first lane L0.
__device__ __forceinline__ Two warp_tile_keys(const float* mind, int L0,
                                              int start, int end, int lane) {
    Two s{kMaxKey, kMaxKey};
    for (int j = start + lane; j < end; j += 32)
        s = two_insert(s, pack_key(mind[j - L0], j));
    return warp_two(s);
}

// Pivot q as chunk slot 0: its row (when pivot rows are staged), aux and
// index.
__device__ __forceinline__ void prefetch_pivot(const float* X,
                                               const float* aux, int q, int d,
                                               bool pstaged, float* prow,
                                               float* paux, int* pidx,
                                               int tid) {
    if (pstaged)
        for (int k = tid; k < d; k += THREADS)
            prow[k] = X[static_cast<size_t>(q) * d + k];
    if (tid == 0) {
        paux[0] = aux[q];
        pidx[0] = q;
    }
}

// Fold the chunk's pivots order[c0:c0 + cnt] (slots 0..cnt-1 of prow /
// paux / pidx) into every unselected lane of [L0, L1) whose tile folds
// from nfrom[T - T0] <= a pivot of the chunk: thread per lane, four pivots
// at a time (pair_dissim4), the rest one by one.
template <int KIND>
__device__ __forceinline__ void fold_lanes(
    const Params& P, const float* xb, size_t xs, float* mind,
    const float* laux, const float* X, const float* prow, const float* paux,
    const int* pidx, int L0, int L1, int T0, const int* nfrom, int c0,
    int cnt, int tid) {
    const float inf = __int_as_float(0x7f800000);
    const int d = P.d;
    for (int j = L0 + tid; j < L1; j += THREADS) {
        const int k0 = nfrom[j / P.block - T0];
        if (k0 >= c0 + cnt) continue;
        float m = mind[j - L0];
        if (m == inf) continue;
        const float* xj = xb + static_cast<size_t>(j - L0) * xs;
        const float aj = laux[j - L0];
        int r = max(k0 - c0, 0);
        for (; r + 4 <= cnt; r += 4) {
            const float* y[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                y[i] = P.pstaged ? prow + (r + i) * d
                                 : X + static_cast<size_t>(pidx[r + i]) * d;
            float v[4];
            pair_dissim4<KIND>(xj, y, d, P.vec4, aj, paux + r, v);
            m = fminf(fminf(fminf(fminf(m, v[0]), v[1]), v[2]), v[3]);
        }
        for (; r < cnt; ++r) {
            const float* y = P.pstaged ? prow + r * d
                                       : X + static_cast<size_t>(pidx[r]) * d;
            m = fminf(m, pair_dissim<KIND>(xj, y, d, P.vec4, aj, paux[r]));
        }
        mind[j - L0] = m;
    }
}

template <int KIND>
__global__ void __launch_bounds__(THREADS, 1)
prim_persist_kernel(const Params P) {
    __shared__ Part s_part[WARPS];
    __shared__ Xc s_xc[WARPS];
    __shared__ ArgKey s_key[WARPS];
    __shared__ int s_cmin;
    extern __shared__ __align__(16) float dyn[];

    const int z = blockIdx.x / P.G;       // the lane
    const int g = blockIdx.x - z * P.G;   // this CTA within its group
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int n = P.n, d = P.d, block = P.block;
    const size_t zn = static_cast<size_t>(z) * n;
    const size_t zb = static_cast<size_t>(z) * P.nblk;
    const float* __restrict__ X = P.X + zn * d;
    const float* __restrict__ aux = P.aux + zn;
    const float* __restrict__ cent = P.cent + zb * d;
    const float* __restrict__ rad = P.rad + zb;
    Slot* slots = P.slots + static_cast<size_t>(z) * 2 * P.G;
    long long* order = P.order + zn;
    float* edges = P.edges + zn;
    const int i0 = static_cast<int>(P.i0[z]);
    const float slack_sq = P.slack[z];
    const float inf = __int_as_float(0x7f800000);

    // owned tiles [T0, T1), lanes [L0, L1); empty for a CTA past the tiles
    const int T0 = min(P.nblk, g * P.tpc);
    const int T1 = min(P.nblk, T0 + P.tpc);
    const int L0 = T0 * block;
    const int L1 = min(n, T1 * block);

    // shared memory, each region 16-byte aligned: the pivot chunk (rows
    // when pstaged, aux, indices); when staged, the CTA's rows, frontier,
    // aux and tile state.  Lanes are indexed j - L0, tiles T - T0.
    const size_t nl = static_cast<size_t>(P.tpc) * block;
    const size_t lanes4 = (nl + 3) & ~size_t{3};
    float* prow = dyn;
    float* paux = prow + (P.pstaged ? ((P.pc * d + 3) & ~3) : 0);
    int* pidx = reinterpret_cast<int*>(paux + ((P.pc + 3) & ~3));
    float* srows = reinterpret_cast<float*>(pidx + ((P.pc + 3) & ~3));
    float* smind = srows + (P.staged ? (nl * P.stride + 3) & ~size_t{3} : 0);
    float* saux = smind + lanes4;
    ArgKey* tk1 = reinterpret_cast<ArgKey*>(saux + lanes4);
    ArgKey* tk2 = tk1 + P.tpc;
    float* pend = reinterpret_cast<float*>(tk2 + P.tpc);
    int* nfold = reinterpret_cast<int*>(pend + P.tpc);
    int* live = nfold + P.tpc;
    int* nfrom = live + P.tpc;
    const float* xb = srows;
    size_t xs = P.stride;
    float* mind = smind;
    const float* laux = saux;
    if (!P.staged) {
        xb = X + static_cast<size_t>(L0) * d;
        xs = d;
        mind = P.mind + zn + L0;
        laux = aux + L0;
        tk1 = P.tk1 + zb + T0;
        tk2 = P.tk2 + zb + T0;
        pend = P.pend + zb + T0;
        nfold = P.nfold + zb + T0;
        live = P.live + zb + T0;
        nfrom = P.nfrom + zb + T0;
    }

    if (P.staged) {
        for (int e = tid; e < (L1 - L0) * d; e += THREADS) {
            const int r = e / d;
            srows[static_cast<size_t>(r) * P.stride + (e - r * d)] =
                X[static_cast<size_t>(L0) * d + e];
        }
        for (int j = L0 + tid; j < L1; j += THREADS) saux[j - L0] = aux[j];
    }
    for (int j = L0 + tid; j < L1; j += THREADS)
        mind[j - L0] = j == i0 ? inf : FLT_MAX;
    for (int T = T0 + tid; T < T1; T += THREADS) {
        const int start = T * block;
        const int len = min(n, start + block) - start;
        const int lv = len - (start <= i0 && i0 < start + len ? 1 : 0);
        live[T - T0] = lv;
        // only the value matters before the first fold: FLT_MAX <= U
        tk1[T - T0] = lv > 0 ? pack_key(FLT_MAX, start) : kMaxKey;
        tk2[T - T0] = kMaxKey;
        pend[T - T0] = inf;
        nfold[T - T0] = 0;
    }
    if (g == 0 && tid == 0) {
        order[0] = i0;
        edges[0] = 0.0f;
    }
    if (tid == 0) s_cmin = 1;
    prefetch_pivot(X, aux, i0, d, P.pstaged, prow, paux, pidx, tid);
    __syncthreads();

    long long tiles_folded = 0, rows_folded = 0, pairs = 0;  // per thread
    unsigned long long barriers = 0;
    int live_tiles = 0;  // thread 0's count of the CTA's live tiles
    if (tid == 0)
        for (int T = T0; T < T1; ++T) live_tiles += live[T - T0] > 0;
    int q = i0;
    unsigned U = ordered_bits(FLT_MAX);  // every live tile folds at t = 1
    for (int t = 1; t < n; ++t) {
        Part part{{kMaxKey, kMaxKey}, kMaxBits};
        if (!P.prune) {
            // eager: every unselected lane folds the last pivot (prefetched)
            // and every live tile is fresh, so the CTA's partial is the
            // least key of its lanes
            const float* yq = P.pstaged ? prow
                                        : X + static_cast<size_t>(q) * d;
            ArgKey key = kMaxKey;
            for (int j = L0 + tid; j < L1; j += THREADS) {
                float m = mind[j - L0];
                if (m == inf) continue;
                m = fminf(m, pair_dissim<KIND>(
                                 xb + static_cast<size_t>(j - L0) * xs, yq, d,
                                 P.vec4, laux[j - L0], paux[0]));
                mind[j - L0] = m;
                key = min_key(key, pack_key(m, j));
                ++pairs;
            }
            if (tid == 0) {
                tiles_folded += live_tiles;
                rows_folded += live_tiles;
            }
            part.k.a = block_min_key(key, s_key);
        } else {
            // 1. warp per owned tile: the new pivot's bound and the decision
            const float* xq = P.pstaged ? prow
                                        : X + static_cast<size_t>(q) * d;
            for (int T = T0 + warp; T < T1; T += WARPS) {
                const int lv = live[T - T0];
                if (lv == 0) {
                    if (lane == 0) nfrom[T - T0] = t;
                    continue;
                }
                float pe = fminf(
                    pend[T - T0],
                    warp_tile_lb<KIND>(cent + static_cast<size_t>(T) * d,
                                       rad[T], xq, d, P.margin, slack_sq,
                                       lane));
                const bool fold =
                    min(key_bits(tk1[T - T0]), ordered_bits(pe)) <= U;
                __syncwarp();  // every lane has read the tile's state
                if (lane == 0) {
                    int from = t;
                    if (fold) {
                        from = nfold[T - T0];
                        nfold[T - T0] = t;
                        pe = inf;
                        atomicMin(&s_cmin, from);
                        ++tiles_folded;
                        rows_folded += t - from;
                        pairs += static_cast<long long>(t - from) * lv;
                    }
                    pend[T - T0] = pe;
                    nfrom[T - T0] = from;
                }
            }
            __syncthreads();

            // 2. fold the pending pivots order[nfrom[T]:t] into the folding
            // tiles: the last pivot alone (prefetched), or staged in chunks
            const int cmin = s_cmin;
            if (cmin == t - 1) {
                fold_lanes<KIND>(P, xb, xs, mind, laux, X, prow, paux, pidx,
                                 L0, L1, T0, nfrom, t - 1, 1, tid);
            } else {
                for (int c0 = cmin; c0 < t; c0 += P.pc) {
                    const int cnt = min(P.pc, t - c0);
                    if (c0 != cmin) __syncthreads();  // the last chunk is read
                    if (P.G > 1 && tid < cnt) __threadfence();  // see order[]
                    for (int e = tid; e < cnt; e += THREADS) {
                        const int c = c0 + e;
                        const int p = c == t - 1
                            ? q : static_cast<int>(__ldcg(order + c));
                        pidx[e] = p;
                        paux[e] = aux[p];
                    }
                    if (P.pstaged) {
                        __syncthreads();
                        for (int e = tid; e < cnt * d; e += THREADS) {
                            const int r = e / d;
                            prow[e] = X[static_cast<size_t>(pidx[r]) * d
                                        + (e - r * d)];
                        }
                    }
                    __syncthreads();
                    fold_lanes<KIND>(P, xb, xs, mind, laux, X, prow, paux,
                                     pidx, L0, L1, T0, nfrom, c0, cnt, tid);
                }
            }
            __syncthreads();

            // 3. warp per owned tile: a folded (fresh) tile's two least
            // keys, a stale tile's stored minimum; the CTA's partial
            for (int T = T0 + warp; T < T1; T += WARPS) {
                if (live[T - T0] == 0) continue;
                if (nfrom[T - T0] < t) {
                    const int start = T * block;
                    const Two k = warp_tile_keys(mind, L0, start,
                                                 min(n, start + block), lane);
                    if (lane == 0) {
                        tk1[T - T0] = k.a;
                        tk2[T - T0] = k.b;
                    }
                    part.k = two_merge(part.k, k);
                } else {
                    part.s = min(part.s, key_bits(tk1[T - T0]));
                }
            }
            if (lane == 0) s_part[warp] = part;
            __syncthreads();
            part = warp_part(lane < WARPS
                                 ? s_part[lane]
                                 : Part{{kMaxKey, kMaxKey}, kMaxBits});
        }

        // 4. the exchange: one barrier a step
        Xc best{part.k.a, min(key_bits(part.k.b), part.s), 0u};
        if (P.G > 1) {
            Slot* sl = slots + (t & 1) * P.G;
            const unsigned tag = step_tag(t);
            if (tid == 0) {
                // pruned: order[t - 1] must be seen by any CTA that reads
                // it (a catch-up fold, a step later at the earliest)
                if (P.prune) __threadfence();
                slot_store(sl + g, part.k.a, best.x,
                           min(key_bits(part.k.a), part.s), tag);
            }
            Xc v = no_slot();
            if (tid < P.G) v = slot_wait(sl + tid, tag);
            v = warp_xc(v);
            if (lane == 0) s_xc[warp] = v;
            __syncthreads();
            best = warp_xc(lane < WARPS ? s_xc[lane] : no_slot());
        }
        ++barriers;
        // unreachable: t < n has a live lane, and U bounds the edge
        if (key_bits(best.f) == kMaxBits) __trap();
        if (P.prune && key_bits(best.f) > U) __trap();

        // 5. the winner's owner closes its lane and, pruned, refreshes its
        // tile's keys
        const int qn = static_cast<int>(key_index(best.f));
        const int Tw = qn / block;
        if (Tw >= T0 && Tw < T1 && warp == 0) {
            if (lane == 0) {
                const float m = mind[qn - L0];
                if (ordered_bits(m) != key_bits(best.f)) __trap();
                mind[qn - L0] = inf;
                order[t] = qn;
                edges[t] = m;
                live_tiles -= --live[Tw - T0] == 0;
            }
            if (P.prune) {
                __syncwarp();
                const int start = Tw * block;
                const Two k = warp_tile_keys(mind, L0, start,
                                             min(n, start + block), lane);
                if (lane == 0) {
                    tk1[Tw - T0] = k.a;
                    tk2[Tw - T0] = k.b;
                }
            }
        }
        if (tid == 0) s_cmin = t + 1;
        q = qn;
        U = best.x;
        // the next pivot's row, fetched while the owner refreshes its tile
        prefetch_pivot(X, aux, q, d, P.pstaged, prow, paux, pidx, tid);
        __syncthreads();
    }
    unsigned long long* stats = P.stats + 4 * static_cast<size_t>(z);
    if (tiles_folded > 0 || pairs > 0) {
        atomicAdd(stats + 0, static_cast<unsigned long long>(tiles_folded));
        atomicAdd(stats + 1, static_cast<unsigned long long>(rows_folded));
        atomicAdd(stats + 2, static_cast<unsigned long long>(pairs));
    }
    if (g == 0 && tid == 0) atomicAdd(stats + 3, barriers);
}

// Pending-pivot chunks: up to MAX_CHUNK pivots, their rows staged while a
// chunk of CHUNK_BYTES holds at least 4 of them (d <= 3,070); above that
// only their indices and aux, the rows read from global memory.
constexpr int MAX_CHUNK = 64;
constexpr int CHUNK_BYTES = 48 * 1024;

struct Plan {
    int G, tpc, pc, stride;
    bool pstaged, staged;
    size_t smem;
};

size_t round16(size_t bytes) { return (bytes + 15) & ~size_t{15}; }

// The launch's shape: G, the tile split, the chunk, and whether the rows
// are staged; the same for the same arguments (launch recomputes it).
template <int KIND>
cudaError_t make_plan(int b, int n, int d, int block, int max_group,
                      Plan* out) {
    auto kernel = prim_persist_kernel<KIND>;
    int dev = 0, sms = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes fa;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return err;
    const size_t avail = static_cast<size_t>(optin) - fa.sharedSizeBytes;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(avail));
    if (err != cudaSuccess) return err;

    Plan p{};
    const int nblk = (n + block - 1) / block;
    const int fit = CHUNK_BYTES / (4 * d + 8);
    p.pstaged = fit >= 4;
    p.pc = p.pstaged ? std::min(fit, MAX_CHUNK) : MAX_CHUNK;
    const size_t pc = static_cast<size_t>(p.pc);
    const size_t chunk = (p.pstaged ? round16(4 * pc * d) : 0)
                         + 2 * round16(4 * pc);
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, THREADS,
                                                        chunk);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    long long G = std::max(1LL, static_cast<long long>(occ) * sms / b);
    G = std::min(G, static_cast<long long>(std::min(nblk, THREADS)));
    if (max_group > 0) G = std::min(G, static_cast<long long>(max_group));
    p.G = static_cast<int>(G);
    p.tpc = (nblk + p.G - 1) / p.G;
    // a row stride whose 16-byte (or 4-byte) count is odd: a warp's reads
    // of feature k over consecutive rows fall in distinct banks
    p.stride = (d & 3) == 0 ? 4 * ((d / 4) | 1) : (d | 1);
    const size_t lanes = static_cast<size_t>(p.tpc) * block;
    const size_t staged = chunk + round16(4 * lanes * p.stride)
                          + 2 * round16(4 * lanes)
                          + 32 * static_cast<size_t>(p.tpc);
    p.staged = false;
    if (staged <= avail) {
        int occ2 = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ2, kernel,
                                                            THREADS, staged);
        if (err != cudaSuccess) return err;
        p.staged = p.G == 1 ? occ2 >= 1
                            : static_cast<long long>(occ2) * sms
                                  >= static_cast<long long>(b) * p.G;
    }
    p.smem = p.staged ? staged : chunk;
    *out = p;
    return cudaSuccess;
}

template <int KIND>
cudaError_t launch(Params P, int b, int group, cudaStream_t stream) {
    Plan p;
    cudaError_t err = make_plan<KIND>(b, P.n, P.d, P.block, group, &p);
    if (err != cudaSuccess) return err;
    if (p.G != group) return cudaErrorInvalidValue;  // slots sized for group
    P.G = p.G;
    P.tpc = p.tpc;
    P.pc = p.pc;
    P.stride = p.stride;
    P.pstaged = p.pstaged;
    P.staged = p.staged;
    const dim3 grid(static_cast<unsigned>(b) * p.G);
    if (p.G > 1) {
        void* args[] = {&P};
        return cudaLaunchCooperativeKernel(
            reinterpret_cast<void*>(prim_persist_kernel<KIND>), grid,
            dim3(THREADS), args, p.smem, stream);
    }
    prim_persist_kernel<KIND><<<grid, THREADS, p.smem, stream>>>(P);
    return cudaGetLastError();
}

template <int KIND>
cudaError_t plan_of(int b, int n, int d, int block, int max_group, int* out) {
    Plan p;
    const cudaError_t err = make_plan<KIND>(b, n, d, block, max_group, &p);
    if (err != cudaSuccess) return err;
    out[0] = p.G;
    out[1] = p.tpc;
    out[2] = p.staged;
    out[3] = static_cast<int>(p.smem);
    out[4] = p.pstaged;
    return cudaSuccess;
}

}  // namespace

// The launch plan for b lanes of (n, d) at tile length block, G capped by
// max_group when it is > 0: out = [G, tiles a CTA, rows staged, dynamic
// shared memory bytes, pivot rows staged].
extern "C" int repro_prim_persist_plan(int b, int n, int d, int block,
                                       int kind, int max_group, int* out) {
    if (b < 1 || n < 1 || d < 1 || block < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    switch (kind) {
        case GRAM_SQEUCLIDEAN:
            return plan_of<GRAM_SQEUCLIDEAN>(b, n, d, block, max_group, out);
        case GRAM_EUCLIDEAN:
            return plan_of<GRAM_EUCLIDEAN>(b, n, d, block, max_group, out);
        case COSINE:
            return plan_of<COSINE>(b, n, d, block, max_group, out);
        case DIRECT_SQEUCLIDEAN:
            return plan_of<DIRECT_SQEUCLIDEAN>(b, n, d, block, max_group, out);
        case DIRECT_EUCLIDEAN:
            return plan_of<DIRECT_EUCLIDEAN>(b, n, d, block, max_group, out);
        case MANHATTAN:
            return plan_of<MANHATTAN>(b, n, d, block, max_group, out);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

// b lanes (b = 1 for one traversal), each at its stride in every array,
// on a group of `group` CTAs each (the plan's G).  X (b, n, d) f32
// row-major; aux (b, n) f32 (metric_aux); i0 (b,) device int64 (read by
// the kernel, so nothing syncs before the launch); cent (b, nblk, d) and
// rad (b, nblk) the tile bounds; slack (b,) device f32, lane z's
// squared-unit allowance lb_slack_ulps(form) * eps * max(aux[z]).
// Scratch: mind (b, n), pend (b, nblk) f32; tk1, tk2 (b, nblk) int64;
// nfold, live, nfrom (b, nblk) int32; slots (b, 2, group) of 128 bytes,
// zeroed.  Out: order (b, n) int64, edges (b, n) f32, stats (b, 4) int64,
// zeroed.  kind as kernels/pairwise_dist.py's _KINDS.
extern "C" int repro_prim_persist(
    const float* X, const float* aux, const long long* i0, const float* cent,
    const float* rad, const float* slack, float margin, int b, int n, int d,
    int block, int kind, int prune, int group, float* mind, float* pend,
    unsigned long long* tk1, unsigned long long* tk2, int* nfold, int* live,
    int* nfrom, void* slots, long long* order, float* edges,
    unsigned long long* stats, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (b < 1 || n < 1 || d < 1 || block < 1 || group < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    Params P{};
    P.X = X;
    P.aux = aux;
    P.i0 = i0;
    P.cent = cent;
    P.rad = rad;
    P.slack = slack;
    P.mind = mind;
    P.pend = pend;
    P.tk1 = tk1;
    P.tk2 = tk2;
    P.nfold = nfold;
    P.live = live;
    P.nfrom = nfrom;
    P.slots = static_cast<Slot*>(slots);
    P.order = order;
    P.edges = edges;
    P.stats = stats;
    P.margin = margin;
    P.n = n;
    P.d = d;
    P.block = block;
    P.nblk = (n + block - 1) / block;
    P.prune = prune;
    P.vec4 = rows_are_vec4(X, d);
    switch (kind) {
        case GRAM_SQEUCLIDEAN:
            return launch<GRAM_SQEUCLIDEAN>(P, b, group, st);
        case GRAM_EUCLIDEAN:
            return launch<GRAM_EUCLIDEAN>(P, b, group, st);
        case COSINE:
            return launch<COSINE>(P, b, group, st);
        case DIRECT_SQEUCLIDEAN:
            return launch<DIRECT_SQEUCLIDEAN>(P, b, group, st);
        case DIRECT_EUCLIDEAN:
            return launch<DIRECT_EUCLIDEAN>(P, b, group, st);
        case MANHATTAN:
            return launch<MANHATTAN>(P, b, group, st);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
