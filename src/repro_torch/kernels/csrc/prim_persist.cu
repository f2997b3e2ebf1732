// The whole exact Prim (VAT) traversal of X in one launch, with lazy tile
// pruning: the flashvat rung's default ("Turbo") engine, CUDA C++ for
// sm_90a.
//
// Replaces: src/repro/kernels/prim_persist.py::prim_persist_pallas (the TPU
// kernel _persist_kernel).  Same state, same schedule, same outputs:
//   mind[j]   frontier; +inf = selected, UNSEEN (FLT_MAX) = nothing folded
//   tmin[T]   min of tile T's stored (maybe stale) lanes
//   pend[T]   lower bound on every pivot not yet folded into tile T
//   nfold[T]  how many pivots (a prefix of order) tile T has folded
// Each step t: every tile's pend takes the bound of the new pivot q
// (triangle inequality off the tile's centroid and radius, shrunk by
// margin and debited the slack); then, while the lowest bound
// min(tmin, pend) of a foldable tile (nfold < t, tmin < inf) is <= the best
// exact candidate (min tmin over tiles with nfold == t), the lowest-bound
// tile, lowest index first, folds every pending pivot order[nfold[T]:t]
// (+inf lanes stay +inf), its tmin is recomputed, its pend reset to +inf.
// The winner is the first lane holding that best value; it becomes +inf.
// A stale lane is >= its tile's bound > best, so pruning changes no bit of
// order or edges: only the work moves.  stats = [tile folds, pivot-row
// folds, pair evaluations]; a pair evaluation is one (pivot, unselected
// lane) dissimilarity, k * L of them for a fold of k pivots into a tile
// with L live lanes (selected lanes are skipped).  Every exact schedule
// makes exactly n (n - 1) / 2: a lane's tile folds every earlier pivot,
// once, before the lane can win.  So pruning saves tile folds, not
// arithmetic.
//
// What bounds it on the H100: the bytes are X read once plus O(n) outputs
// (12.8 MB at n = 50,000, d = 64: 3.8 us at 3.35 TB/s); the operations are
// one FMA per feature and pair evaluation, 2 * d * stats[2] f32 operations
// (2.4 ms at 67 TFLOP/s at n = 50,000, d = 64).  So the card's bound is
// operations.  This kernel is far from it: the recurrence is serial (each
// pivot depends on the last step), and it runs on one SM.
//
// Design: one persistent CTA of 512 threads walks all n - 1 steps, so no
// grid-wide barrier is needed.  The state (mind, tmin, pend, nfold, live,
// order, edges: about 1 MB at n = 50,000) lives in global memory, where
// the 50 MB L2 holds it with X (12.8 MB at d = 64), so there is no cap on
// n, unlike the TPU kernel's VMEM budget.  Tiles are 1,024 lanes by
// default (the wrapper's DEFAULT_BLOCK, the reference's too): a fold's
// fixed cost (its barriers and the loads on its critical path) outweighs
// its arithmetic, so fewer, wider folds run faster.  A fold copies the
// pending pivots' rows into shared memory, up to 64 at a time (16 KB at d =
// 64), and each thread folds them into its lanes four at a time
// (pair_dissim4: four independent FMA chains over one read of the lane's row,
// which comes from global memory through L1, float4 where aligned).  Each
// lane's value is computed by the code of dissim.cuh that pairwise_dist.cu
// and prim_stream.cu run, in the same order, so every engine sees the same
// bits.  Every loop bound and branch that holds a __syncthreads() is
// CTA-uniform: tile choice, fold-loop exit and winner all come out of
// block-wide key reductions (argmin_key.cuh), whose result every thread
// receives.  The best candidate and the fold choice are one reduction of two
// packed (value, tile) keys; the winner is found by scanning only the first
// tile whose fresh tmin equals best.
//
// A batch of b traversals (the reference vmaps its XLA mirror there, since
// its megakernel is solo-only) is one launch of b CTAs, one per lane:
// lane z = blockIdx.x offsets every pointer of the state (X, aux, the tile
// bounds, mind, tmin, pend, nfold, live, order, edges, stats) to its lane's
// stride and reads its own seed and slack, so each CTA runs exactly the
// single traversal's code and each lane's order and edges are the single
// launch's bits.  The b lanes fill b of the 132 SMs at once instead of
// running one after another.
#include <cuda_runtime.h>

#include <cfloat>

#include "argmin_key.cuh"
#include "dissim.cuh"

namespace {

using namespace repro_torch;

constexpr int THREADS = 512;

// Two block-wide key minima with one pair of barriers; every thread gets
// both.  scratch holds 64 keys.  Like block_min_key it opens with a
// __syncthreads(), so it publishes every earlier store of the CTA.
__device__ __forceinline__ void block_min_key2(ArgKey& a, ArgKey& b,
                                               ArgKey* scratch) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    a = warp_min_key(a);
    b = warp_min_key(b);
    __syncthreads();
    if (lane == 0) {
        scratch[warp] = a;
        scratch[32 + warp] = b;
    }
    __syncthreads();
    a = warp_min_key(lane < nwarps ? scratch[lane] : kMaxKey);
    b = warp_min_key(lane < nwarps ? scratch[32 + lane] : kMaxKey);
}

// Lower bound on the dissimilarity of pivot xq to any lane of a tile with
// centroid c and radius rad, in the metric's units (prim_persist.py's
// tile_lb): direct-form centroid distance, L1 for manhattan; minus the
// radius, times margin; the gram slack debited in squared units.  Cosine
// has rad = +inf, so its bound is 0 and it never prunes.
template <int KIND>
__device__ __forceinline__ float tile_lb(const float* __restrict__ c,
                                         float rad,
                                         const float* __restrict__ xq, int d,
                                         float margin, float slack_sq) {
    float s = 0.0f;
    for (int k = 0; k < d; ++k) {
        const float diff = c[k] - xq[k];
        s = KIND == MANHATTAN ? s + fabsf(diff) : fmaf(diff, diff, s);
    }
    const float dq = KIND == MANHATTAN ? s : sqrtf(fmaxf(s, 0.0f));
    const float e = fmaxf(dq - rad, 0.0f) * margin;
    if (KIND == GRAM_EUCLIDEAN || KIND == DIRECT_EUCLIDEAN)
        return fmaxf(e - sqrtf(slack_sq), 0.0f);
    if (KIND == GRAM_SQEUCLIDEAN || KIND == DIRECT_SQEUCLIDEAN)
        return fmaxf(e * e - slack_sq, 0.0f);
    return e;
}

struct State {
    const float* X;
    const float* aux;
    const float* cent;
    const float* rad;
    float* mind;
    float* tmin;
    float* pend;
    int* nfold;
    int* live;    // unselected lanes per tile
    long long* order;
    float* edges;
    int n, d, block, nblk;
    int pc;       // pending pivots per shared-memory chunk
    bool staged;  // the chunk's rows are copied to shared memory
    bool vec4;
};

// Fold every pending pivot order[nfold[T]:t] into tile T; then tmin[T] is
// the tile's new minimum, pend[T] = +inf, nfold[T] = t.  No lane of T is
// selected while T has pending pivots (only a fresh tile wins), so the
// fold evaluates exactly live[T] lanes against each of them.  The pending
// pivots go through shared memory in chunks of s.pc: their indices and aux
// entries, and their rows too when s.staged.  Each lane folds four pivots
// at a time (pair_dissim4).
template <int KIND>
__device__ __forceinline__ void fold_tile(const State& s, int T, int t,
                                          ArgKey* scratch, float* prow,
                                          float* paux, int* pidx,
                                          long long& tiles_folded,
                                          long long& rows_folded,
                                          long long& pairs) {
    const float inf = __int_as_float(0x7f800000);
    const int start = T * s.block;
    const int end = min(s.n, start + s.block);
    const int k0 = s.nfold[T];
    for (int c0 = k0; c0 < t; c0 += s.pc) {
        const int cnt = min(s.pc, t - c0);
        __syncthreads();  // every read of the previous chunk is done
        for (int e = threadIdx.x; e < cnt; e += blockDim.x) {
            const int p = static_cast<int>(s.order[c0 + e]);
            pidx[e] = p;
            paux[e] = s.aux[p];
        }
        if (s.staged) {
            __syncthreads();
            for (int e = threadIdx.x; e < cnt * s.d; e += blockDim.x) {
                const int r = e / s.d;
                prow[e] = s.X[static_cast<size_t>(pidx[r]) * s.d
                              + (e - r * s.d)];
            }
        }
        __syncthreads();
        for (int j = start + threadIdx.x; j < end; j += blockDim.x) {
            float m = s.mind[j];
            if (m == inf) continue;
            const float* xj = s.X + static_cast<size_t>(j) * s.d;
            const float aj = s.aux[j];
            int r = 0;
            for (; r + 4 <= cnt; r += 4) {
                const float* y[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    y[i] = s.staged ? prow + (r + i) * s.d
                                    : s.X + static_cast<size_t>(pidx[r + i]) * s.d;
                float v[4];
                pair_dissim4<KIND>(xj, y, s.d, s.vec4, aj, paux + r, v);
                m = fminf(fminf(fminf(fminf(m, v[0]), v[1]), v[2]), v[3]);
            }
            for (; r < cnt; ++r) {
                const float* y = s.staged
                    ? prow + r * s.d
                    : s.X + static_cast<size_t>(pidx[r]) * s.d;
                m = fminf(m, pair_dissim<KIND>(xj, y, s.d, s.vec4, aj,
                                               paux[r]));
            }
            s.mind[j] = m;
        }
    }
    ArgKey key = kMaxKey;
    for (int j = start + threadIdx.x; j < end; j += blockDim.x)
        key = min_key(key, pack_key(s.mind[j], j));
    key = block_min_key(key, scratch);
    if (threadIdx.x == 0) {
        s.tmin[T] = s.mind[key_index(key)];
        s.pend[T] = inf;
        s.nfold[T] = t;
        ++tiles_folded;
        rows_folded += t - k0;
        pairs += static_cast<long long>(t - k0) * s.live[T];
    }
    __syncthreads();
}

// Lane z's view of a batch's state: every array at its lane's stride.
__device__ __forceinline__ State lane_state(State s, size_t z) {
    s.X += z * s.n * s.d;
    s.aux += z * s.n;
    s.cent += z * s.nblk * s.d;
    s.rad += z * s.nblk;
    s.mind += z * s.n;
    s.tmin += z * s.nblk;
    s.pend += z * s.nblk;
    s.nfold += z * s.nblk;
    s.live += z * s.nblk;
    s.order += z * s.n;
    s.edges += z * s.n;
    return s;
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
prim_persist_kernel(State base, const long long* __restrict__ i0p,
                    const float* __restrict__ slack_p, float margin,
                    int prune, long long* __restrict__ stats) {
    __shared__ ArgKey scratch[64];
    const State s = lane_state(base, blockIdx.x);   // one CTA per lane
    i0p += blockIdx.x;
    slack_p += blockIdx.x;
    stats += 3 * static_cast<size_t>(blockIdx.x);
    extern __shared__ __align__(16) float dyn[];
    float* prow = dyn;                                  // pc * d (staged)
    float* paux = dyn + (s.staged ? s.pc * s.d : 0);    // pc
    int* pidx = reinterpret_cast<int*>(paux + s.pc);    // pc
    const float inf = __int_as_float(0x7f800000);
    const int tid = threadIdx.x;
    const int nthr = blockDim.x;
    const int i0 = static_cast<int>(*i0p);
    const float slack_sq = *slack_p;
    long long tiles_folded = 0, rows_folded = 0, pairs = 0;  // thread 0's

    for (int j = tid; j < s.n; j += nthr) s.mind[j] = j == i0 ? inf : FLT_MAX;
    for (int T = tid; T < s.nblk; T += nthr) {
        const int start = T * s.block;
        const int len = min(s.n, start + s.block) - start;
        const bool has_seed = start <= i0 && i0 < start + len;
        s.tmin[T] = len == 1 && has_seed ? inf : FLT_MAX;
        s.live[T] = len - (has_seed ? 1 : 0);
        s.pend[T] = inf;
        s.nfold[T] = 0;
    }
    if (tid == 0) {
        s.order[0] = i0;
        s.edges[0] = 0.0f;
    }
    __syncthreads();

    int q = i0;
    for (int t = 1; t < s.n; ++t) {
        const float* xq = s.X + static_cast<size_t>(q) * s.d;
        for (int T = tid; T < s.nblk; T += nthr) {
            const float lb = prune
                ? tile_lb<KIND>(s.cent + static_cast<size_t>(T) * s.d,
                                s.rad[T], xq, s.d, margin, slack_sq)
                : 0.0f;
            s.pend[T] = fminf(s.pend[T], lb);
        }
        // lazy-fold loop; block_min_key2 opens with a barrier, which
        // publishes the pend updates above and every fold's stores
        ArgKey fold, best;
        for (int fuel = 0;; ++fuel) {
            fold = kMaxKey;
            best = kMaxKey;
            for (int T = tid; T < s.nblk; T += nthr) {
                const int nf = s.nfold[T];
                const float tm = s.tmin[T];
                const float bound = nf < t && tm < inf ? fminf(tm, s.pend[T])
                                                       : inf;
                fold = min_key(fold, pack_key(bound, T));
                if (nf == t) best = min_key(best, pack_key(tm, T));
            }
            block_min_key2(fold, best, scratch);
            // bound <= best exact candidate (ordered bits are monotone)
            if ((fold >> 32) > (best >> 32)) break;
            // A tile folds at most once a step, so after nblk folds no
            // bound is finite and best is: reaching here again means the
            // state is corrupt.  The impossible states below fail the
            // launch too, rather than leave order[t:] unwritten.
            if (fuel == s.nblk) __trap();
            fold_tile<KIND>(s, static_cast<int>(key_index(fold)), t, scratch,
                            prow, paux, pidx, tiles_folded, rows_folded,
                            pairs);
        }
        if (best == kMaxKey) __trap();  // unreachable: t < n has a live lane

        // winner: the first lane of the first fresh tile whose min is best
        const int Tw = static_cast<int>(key_index(best));
        const float bestv = s.tmin[Tw];
        const int start = Tw * s.block;
        const int end = min(s.n, start + s.block);
        ArgKey win = kMaxKey;
        for (int j = start + tid; j < end; j += nthr)
            if (s.mind[j] == bestv) win = min_key(win, static_cast<ArgKey>(j));
        win = block_min_key(win, scratch);
        if (win == kMaxKey) __trap();  // unreachable: tmin[Tw] is in Tw
        q = static_cast<int>(key_index(win));
        if (tid == 0) {
            s.mind[q] = inf;
            s.order[t] = q;
            s.edges[t] = bestv;
            --s.live[Tw];
        }
        __syncthreads();
        ArgKey m = kMaxKey;
        for (int j = start + tid; j < end; j += nthr)
            m = min_key(m, pack_key(s.mind[j], j));
        m = block_min_key(m, scratch);
        if (tid == 0) s.tmin[Tw] = s.mind[key_index(m)];
        __syncthreads();
    }
    if (tid == 0) {
        stats[0] = tiles_folded;
        stats[1] = rows_folded;
        stats[2] = pairs;
    }
}

// Shared memory for the pending-pivot chunks, under the 48 KB that needs
// no opt-in: up to 64 pivots, their rows staged while each chunk holds at
// least 4 of them (d <= 3,070); above that only indices and aux.
constexpr int MAX_CHUNK = 64;
constexpr int CHUNK_BYTES = 48 * 1024;

template <int KIND>
cudaError_t launch(const State& s, const long long* i0, const float* slack,
                   float margin, int prune, long long* stats, int b,
                   cudaStream_t stream) {
    const size_t smem = (s.staged ? static_cast<size_t>(s.pc) * s.d : 0) * 4
                        + static_cast<size_t>(s.pc) * 8;
    prim_persist_kernel<KIND><<<b, THREADS, smem, stream>>>(
        s, i0, slack, margin, prune, stats);
    return cudaGetLastError();
}

}  // namespace

// b lanes (b = 1 for one traversal), each at its stride in every array.
// X (b, n, d) f32 row-major; aux (b, n) f32 (metric_aux); i0 (b,) device
// int64 (read by the kernel, so nothing syncs before the launch); cent
// (b, nblk, d) and rad (b, nblk) the tile bounds; slack (b,) device f32,
// lane z's squared-unit allowance lb_slack_ulps(form) * eps * max(aux[z]).
// Scratch: mind (b, n), tmin, pend (b, nblk) f32, nfold, live (b, nblk) int.
// Out: order (b, n) int64, edges (b, n) f32, stats (b, 3) int64.  kind as
// kernels/pairwise_dist.py's _KINDS.
extern "C" int repro_prim_persist(const float* X, const float* aux,
                                  const long long* i0, const float* cent,
                                  const float* rad, const float* slack,
                                  float margin, int b, int n, int d,
                                  int block, int kind, int prune, float* mind,
                                  float* tmin, float* pend, int* nfold,
                                  int* live, long long* order, float* edges,
                                  long long* stats, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (b < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int fit = CHUNK_BYTES / (4 * d + 8);
    const bool staged = fit >= 4;
    State s{X, aux, cent, rad, mind, tmin, pend, nfold, live, order, edges,
            n, d, block, (n + block - 1) / block,
            staged ? min(fit, MAX_CHUNK) : MAX_CHUNK, staged,
            rows_are_vec4(X, d)};
    switch (kind) {
        case GRAM_SQEUCLIDEAN:
            return launch<GRAM_SQEUCLIDEAN>(s, i0, slack, margin, prune, stats, b, st);
        case GRAM_EUCLIDEAN:
            return launch<GRAM_EUCLIDEAN>(s, i0, slack, margin, prune, stats, b, st);
        case COSINE:
            return launch<COSINE>(s, i0, slack, margin, prune, stats, b, st);
        case DIRECT_SQEUCLIDEAN:
            return launch<DIRECT_SQEUCLIDEAN>(s, i0, slack, margin, prune, stats, b, st);
        case DIRECT_EUCLIDEAN:
            return launch<DIRECT_EUCLIDEAN>(s, i0, slack, margin, prune, stats, b, st);
        case MANHATTAN:
            return launch<MANHATTAN>(s, i0, slack, margin, prune, stats, b, st);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
