// One fused matrix-free Prim step a launch: the flashvat rung's stepwise
// engine (turbo=False) and the sharded engine's per-rank step, CUDA C++ for
// sm_90a.
//
// Replaces: src/repro/kernels/prim_stream.py::prim_stream_step_pallas (the
// TPU kernel _prim_stream_kernel, through _stream_call, with the pivot
// given by index), with a lane axis prim_stream_step_pallas_batch (:265,
// its (b, nblk) slab-of-one grid, the batched stepwise engine of
// vat_matrix_free_batch), and with repro_prim_frontier_step
// prim_frontier_step_pallas (:175, the pivot given by value, the step of
// core/distributed.py::vat_matrix_free_sharded).
//
// The stepwise step: for every lane j
//   mind[j] = min(mind[j], dissim(x_j, x_q))          (updated in place)
// then the first-index (min, argmin) of mind over lanes with selected[j]
// false, as kernels/prim_update.cu writes it.  Recording
// (repro_prim_stream_record, the engines' loop) reads the pivot from
// order[t - 1] and writes order[t], edges[t] and selected[next] itself, so
// a step of the engine is this one launch and nothing else; the parity entry
// (repro_prim_stream_step) takes q and writes the pair into out instead.
//
// The frontier step, one rank's shard of n lanes with global ids offset + j:
// the pivot comes by value, as the least-key slot of the previous step's
// all-gathered table (P slots of W f32 words, each [key (int64), value, aux,
// x (d), zero padding]: kernels/ref.py, slot_width).  CTA 0 records its id
// and value as order[t] and edges[t]; the lane whose id is the pivot's is
// closed to +inf; every other lane folds in band:
//   mind[j] = isinf(mind[j]) ? +inf : fminf(mind[j], dissim(x_j, x_q))
// so a +inf lane (selected or padding) skips its dissimilarity and is never
// revived.  The packed key carries the global id, so the cross-rank choice
// is a min over P keys and, shards being contiguous row blocks, first-rank
// ties are first-index ties.  The step writes this rank's next slot: the
// key with its top bit flipped (a signed int64 compare then orders as the
// unsigned key), the winner's raw mind, its aux entry and its point, so one
// all_gather a step carries everything the next step needs.
//
// What bounds it on the H100: a step reads X once (n d 4 bytes: 12.8 MB at
// n = 50,000, d = 64, 3.8 us at 3.35 TB/s) plus 9 bytes a lane of frontier,
// against n d FMAs (0.1 us at 67 TFLOP/s): bytes.  X is read every step and
// fits in the 50 MB L2, so a warm step reads it from L2, faster than HBM;
// repro_read_floor is the kernel that only reads the same bytes, the floor
// a step is held against beside the HBM bound.  A batched step of b = 4
// lanes at n = 50,000 reads 51 MB of X.
//
// Design:
//   * one launch a step.  Each CTA reduces its lanes to one packed (value,
//     index) key (argmin_key.cuh).  The thread that holds the CTA's least
//     lane writes that lane's raw f32 value (the key folds -0.0 onto +0.0)
//     to the CTA's slot of `raws`, folds the key into the lane's Ticket with
//     one atomicMax of its complement (so zeroed scratch is "no key"),
//     fences, and counts the CTA with atomicAdd.  The thread that counts
//     last reads the least key and the winner's raw value through L2,
//     writes the record (or the pair, or the slot) and resets the ticket
//     for the next step.  The min over packed keys is exact, so any order
//     of CTAs gives the same key and the same bits.  The last CTA reads
//     nothing else that another CTA wrote in this launch: X, aux and the
//     table are inputs.  The tickets (one a lane of a batch) and raws are
//     scratch the caller owns, one a traversal (kernels/prim_stream.py),
//     never a static device variable: two lanes of a batch, or two
//     traversals on two streams, never share a ticket;
//   * coalesced reads of X.  A lane's dissimilarity stays one ascending fmaf
//     chain through dissim.cuh (accumulate, then finish), so the stepwise,
//     persistent, sharded and materialized engines agree bit for bit; so a
//     lane's features are not split across threads.  Instead the caller
//     makes a feature-major copy XT (d rows of n, lane z at z n d) once a
//     traversal, and thread j reads XT[k n + j]: a warp's 32 lanes read one
//     128-byte line a feature (the row-major read touched 32 rows 256 bytes
//     apart).  A lane's features go 32 at a time, all 32 loads issued into
//     registers before the group's FMAs; the pivot's point (row q of X, or
//     the slot's) is read by every lane of a warp at one address (a
//     broadcast through L1), with no barrier before the lane's loads.  No
//     vector loads, so any d and any alignment of X read the same way.
//     Left to itself, the compiler paired each load with its FMA, and one
//     such build ran the step at twice the time; groups of 16, 32 or 64
//     features then differ little (tools/stream_times.py --variants,
//     PERF.md), and neither __ldg for the point nor staging it in shared
//     memory behind a barrier did better;
//   * 128 lanes a CTA, one a thread: 391 CTAs at n = 50,000 put three on
//     127 SMs and two on 5 of the 132 (256-lane CTAs put two on 64 SMs and
//     one on 68);
//   * the batch: lane z of a (b, n, d) stack is blockIdx.y, every operand at
//     its lane's stride, its own ticket and raws, so each lane runs
//     exactly a single step's code and gives its bits.  gridDim.y caps a
//     batch at 65,535 lanes.  The stepwise step folds every lane, selected
//     ones too, as the TPU kernel does; the frontier step skips +inf lanes.
//   * a step needs no host value that changes between steps but t.
#include <cuda_runtime.h>

#include <type_traits>

#include "argmin_key.cuh"
#include "dissim.cuh"

namespace {

using namespace repro_torch;

// The features a lane loads at once; tools/stream_times.py --variants
// builds copies of this file with it overridden.
#ifndef PRIM_STREAM_UNROLL
#define PRIM_STREAM_UNROLL 32
#endif

constexpr int THREADS = 128;       // lanes per CTA of a step, one a thread
constexpr int SLOT_HEAD = 4;       // key (2 words), value, aux; then x
constexpr int FLOOR_THREADS = 256;
constexpr int UNROLL = PRIM_STREAM_UNROLL;   // features loaded at once

__device__ __forceinline__ float f32_inf() { return __int_as_float(0x7f800000); }

// Features [0, d) of one lane against the pivot point xq: one ascending
// accumulate<KIND> chain from 0, feature k of the lane at col[k ld] (a
// column of the feature-major copy), the pivot's features from xq.  The
// features go UNROLL at a time: every load of a group is issued into
// registers before its first FMA, so UNROLL of the lane's loads are in
// flight at once (left to itself, the compiler interleaved each load pair
// with its FMA).  The chain itself is unchanged: feature k's FMA follows
// feature k - 1's.
template <int KIND>
__device__ __forceinline__ float lane_acc(const float* __restrict__ col,
                                          size_t ld,
                                          const float* __restrict__ xq,
                                          int d) {
    float acc = 0.0f;
    int k = 0;
    for (; k + UNROLL <= d; k += UNROLL) {
        float a[UNROLL], b[UNROLL];
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) {
            a[i] = col[static_cast<size_t>(k + i) * ld];
            b[i] = xq[k + i];
        }
#pragma unroll
        for (int i = 0; i < UNROLL; ++i) acc = accumulate<KIND>(acc, a[i], b[i]);
    }
    for (; k < d; ++k)
        acc = accumulate<KIND>(acc, col[static_cast<size_t>(k) * ld], xq[k]);
    return acc;
}

// The ticket of one lane of a step: `best` holds the complement of the
// least key folded in so far (zero, the complement of no key, between
// steps), `count` the CTAs done.
struct Ticket {
    unsigned long long best;
    unsigned count;
    unsigned pad;
};

// Every CTA of a grid row calls this once with its lanes' keys.  The one
// thread that holds the CTA's least lane writes that lane's raw value to
// raws[blockIdx.x], folds the key into the ticket (atomicMax of the
// complement), fences and counts the CTA.  Returns true in that thread of
// the CTA that counted last (every other thread returns false): every
// CTA's key and raw value are then in L2.
__device__ __forceinline__ bool drew_last(ArgKey key, float raw,
                                          float* __restrict__ raws,
                                          Ticket* __restrict__ ticket,
                                          ArgKey* red) {
    const ArgKey best = block_min_key(key, red);
    if (key != best) return false;
    raws[blockIdx.x] = raw;
    atomicMax(&ticket->best, ~best);
    __threadfence();
    const bool last = atomicAdd(&ticket->count, 1u) == gridDim.x - 1;
    __threadfence();
    return last;
}

// In the thread that drew the last ticket: the step's least key, its raw
// value (from the CTA that holds lane `key_index - offset`), and the
// ticket reset for the next step.
__device__ __forceinline__ ArgKey take_result(Ticket* __restrict__ ticket,
                                              const float* __restrict__ raws,
                                              long long offset, float* raw) {
    const ArgKey best = ~__ldcg(&ticket->best);
    *raw = __ldcg(raws + (static_cast<long long>(key_index(best)) - offset)
                  / THREADS);
    ticket->best = 0;
    ticket->count = 0;
    return best;
}

// One step of each lane z = blockIdx.y.  RECORD: the pivot is
// rec_order[z n + t - 1]; the winner goes to rec_order[z n + t],
// rec_edges[z n + t], and sel[z n + winner] = 1.  Otherwise the pivot is
// qp[z] and the pair goes to rec_order[2 z] (index) and the low word of
// rec_order[2 z + 1] (value).
template <int KIND, bool RECORD>
__global__ void __launch_bounds__(THREADS)
stream_step_kernel(const float* __restrict__ XT, const float* __restrict__ X,
                   const float* __restrict__ aux,
                   const long long* __restrict__ qp,
                   float* __restrict__ mind, unsigned char* __restrict__ sel,
                   long long* __restrict__ rec_order,
                   float* __restrict__ rec_edges, int n, int d, int t,
                   Ticket* __restrict__ tickets, float* __restrict__ raws) {
    __shared__ ArgKey red[THREADS / 32];
    const size_t z = blockIdx.y;
    const size_t lane_floats = static_cast<size_t>(n) * d;
    XT += z * lane_floats;
    X += z * lane_floats;
    aux += z * n;
    mind += z * n;
    sel += z * n;
    raws += z * gridDim.x;
    const long long q = RECORD ? rec_order[z * n + t - 1] : qp[z];
    const int j = blockIdx.x * THREADS + threadIdx.x;
    ArgKey key = kMaxKey;
    float raw = 0.0f;
    if (j < n) {
        const float acc = lane_acc<KIND>(XT + j, n, X + q * d, d);
        const float m = fminf(mind[j], finish<KIND>(acc, aux[j], aux[q]));
        mind[j] = m;
        raw = sel[j] ? f32_inf() : m;
        key = pack_key(raw, j);
    }
    if (!drew_last(key, raw, raws, tickets + z, red)) return;
    const unsigned idx = key_index(take_result(tickets + z, raws, 0, &raw));
    if (RECORD) {
        rec_order[z * n + t] = idx;
        rec_edges[z * n + t] = raw;
        sel[idx] = 1;
    } else {
        rec_order[2 * z] = idx;
        reinterpret_cast<float*>(rec_order + 2 * z + 1)[0] = raw;
    }
}

template <typename Fn>
cudaError_t by_kind(int kind, Fn&& fn) {
    switch (kind) {
        case GRAM_SQEUCLIDEAN:
            return fn(std::integral_constant<int, GRAM_SQEUCLIDEAN>{});
        case GRAM_EUCLIDEAN:
            return fn(std::integral_constant<int, GRAM_EUCLIDEAN>{});
        case COSINE:
            return fn(std::integral_constant<int, COSINE>{});
        case DIRECT_SQEUCLIDEAN:
            return fn(std::integral_constant<int, DIRECT_SQEUCLIDEAN>{});
        case DIRECT_EUCLIDEAN:
            return fn(std::integral_constant<int, DIRECT_EUCLIDEAN>{});
        case MANHATTAN:
            return fn(std::integral_constant<int, MANHATTAN>{});
        default:
            return cudaErrorInvalidValue;
    }
}

int nblocks_of(int n) { return (n + THREADS - 1) / THREADS; }

// One Ticket (two words) a lane, then b nblocks raw values (4 bytes each).
size_t scratch_words(int b, int n) {
    return 2 * static_cast<size_t>(b)
           + (static_cast<size_t>(b) * nblocks_of(n) + 1) / 2;
}

template <bool RECORD>
int launch_stream(const float* XT, const float* X, const float* aux,
                  const long long* q, float* mind, unsigned char* sel,
                  long long* rec_order, float* rec_edges, int b, int n, int d,
                  int kind, int t, unsigned long long* scratch,
                  cudaStream_t s) {
    if (b < 1 || b > 65535 || n < 1 || d < 1
            || (RECORD && (t < 1 || t >= n)))
        return static_cast<int>(cudaErrorInvalidValue);
    const int nblocks = nblocks_of(n);
    Ticket* tickets = reinterpret_cast<Ticket*>(scratch);
    float* raws = reinterpret_cast<float*>(scratch + 2 * static_cast<size_t>(b));
    return static_cast<int>(by_kind(kind, [&](auto k) {
        stream_step_kernel<decltype(k)::value, RECORD>
            <<<dim3(nblocks, b), THREADS, 0, s>>>(
                XT, X, aux, q, mind, sel, rec_order, rec_edges, n, d, t,
                tickets, raws);
        return cudaGetLastError();
    }));
}

// ---- the frontier step (repro_prim_frontier_step) --------------------------

__device__ __forceinline__ long long slot_key(const float* slot) {
    return *reinterpret_cast<const long long*>(slot);
}

// The slot of `table` (P slots of W words) with the least signed key, the
// first among equal keys; every thread of every CTA scans the P keys.
__device__ __forceinline__ const float* least_slot(const float* __restrict__ table,
                                                   int P, int W) {
    const float* best = table;
    long long best_key = slot_key(table);
    for (int r = 1; r < P; ++r) {
        const float* slot = table + static_cast<size_t>(r) * W;
        const long long key = slot_key(slot);
        if (key < best_key) {
            best_key = key;
            best = slot;
        }
    }
    return best;
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
frontier_step_kernel(const float* __restrict__ XT,
                     const float* __restrict__ X,
                     const float* __restrict__ aux,
                     const float* __restrict__ table, int P, int W,
                     float* __restrict__ mind, int n, int d, long long offset,
                     long long* __restrict__ order,
                     float* __restrict__ edges, int t,
                     Ticket* __restrict__ ticket, float* __restrict__ raws,
                     float* __restrict__ out) {
    __shared__ ArgKey red[THREADS / 32];
    __shared__ ArgKey win_key;
    __shared__ float win_raw;
    __shared__ int last;
    const float* pivot = least_slot(table, P, W);
    const long long q = slot_key(pivot) & 0xffffffffll;
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        order[t] = q;
        edges[t] = pivot[2];
    }
    if (threadIdx.x == 0) last = 0;
    const int j = blockIdx.x * THREADS + threadIdx.x;
    ArgKey key = kMaxKey;
    float m = 0.0f;
    if (j < n) {
        // every lane reads its row, so that its loads need not wait for
        // mind[j]; a +inf lane keeps +inf and the pivot's lane closes
        const float acc = lane_acc<KIND>(XT + j, n, pivot + SLOT_HEAD, d);
        const float row = finish<KIND>(acc, aux[j], pivot[3]);
        m = mind[j];
        m = offset + j == q ? f32_inf() : isinf(m) ? m : fminf(m, row);
        mind[j] = m;
        key = pack_key(m, static_cast<unsigned>(offset + j));
    }
    if (drew_last(key, m, raws, ticket, red)) {
        win_key = take_result(ticket, raws, offset, &win_raw);
        last = 1;
    }
    __syncthreads();
    if (!last) return;
    // this rank's next slot: the key with its top bit flipped, the winner's
    // raw mind (the edge the solo engines record), aux entry and point
    const ArgKey best = win_key;
    const long long lane = static_cast<long long>(key_index(best)) - offset;
    if (threadIdx.x == 0) {
        *reinterpret_cast<long long*>(out) =
            static_cast<long long>(best ^ (1ull << 63));
        out[2] = win_raw;
        out[3] = aux[lane];
    }
    const float* x = X + lane * d;
    for (int k = threadIdx.x; k < W - SLOT_HEAD; k += THREADS)
        out[SLOT_HEAD + k] = k < d ? x[k] : 0.0f;
}

int launch_frontier(const float* XT, const float* X, const float* aux,
                    const float* table, int P, int W, float* mind, int n,
                    int d, int kind, long long offset, long long* order,
                    float* edges, int t, unsigned long long* scratch,
                    float* out, cudaStream_t s) {
    if (P < 1 || n < 1 || d < 1 || W < SLOT_HEAD + d || W % 4 != 0
            || offset < 0 || offset + n > 0xffffffffll || t < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int nblocks = nblocks_of(n);
    Ticket* ticket = reinterpret_cast<Ticket*>(scratch);
    float* raws = reinterpret_cast<float*>(scratch + 2);
    return static_cast<int>(by_kind(kind, [&](auto k) {
        frontier_step_kernel<decltype(k)::value><<<nblocks, THREADS, 0, s>>>(
            XT, X, aux, table, P, W, mind, n, d, offset, order, edges, t,
            ticket, raws, out);
        return cudaGetLastError();
    }));
}

// Reads count floats once, 16 bytes a thread where aligned, and writes
// nothing unless a CTA's xor of the bits is a value no test input makes:
// the time of reading the bytes a step reads, with no arithmetic on them.
__global__ void __launch_bounds__(FLOOR_THREADS)
read_floor_kernel(const float* __restrict__ x, long long count,
                  unsigned* __restrict__ out) {
    const long long stride = static_cast<long long>(gridDim.x) * FLOOR_THREADS;
    const long long i0 = static_cast<long long>(blockIdx.x) * FLOOR_THREADS
                         + threadIdx.x;
    unsigned acc = 0;
    const long long n4 = (reinterpret_cast<uintptr_t>(x) & 15) ? 0 : count / 4;
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long i = i0; i < n4; i += stride) {
        const float4 v = x4[i];
        acc ^= __float_as_uint(v.x) ^ __float_as_uint(v.y)
               ^ __float_as_uint(v.z) ^ __float_as_uint(v.w);
    }
    for (long long i = 4 * n4 + i0; i < count; i += stride)
        acc ^= __float_as_uint(x[i]);
    if (acc == 0x7fc0beefu) out[blockIdx.x] = acc;
}

}  // namespace

// 8-byte words of one traversal's step scratch for b lanes of n: one
// ticket a lane, then one raw value a CTA.  The tickets must be zero before
// the first step (the wrapper allocates the scratch zeroed); every step
// leaves them zero.
extern "C" long long repro_prim_stream_scratch_words(int b, int n) {
    return static_cast<long long>(scratch_words(b, n));
}

// One step of each of b lanes, the pivot given by index (the parity entry):
// XT (b, d, n) f32 the feature-major copy of X (b, n, d) f32 row-major, aux
// (b, n) f32, q (b,) device int64 (lane z's pivot), mind (b, n) f32
// updated in place, sel (b, n) bool as bytes; out (b, 2) int64: out[z, 0] =
// lane z's next vertex, the low 4 bytes of out[z, 1] its edge (f32).
// 1 <= b <= 65,535.
extern "C" int repro_prim_stream_step(const float* XT, const float* X,
                                      const float* aux, const long long* q,
                                      float* mind, unsigned char* sel, int b,
                                      int n, int d, int kind,
                                      unsigned long long* scratch,
                                      long long* out, void* stream) {
    return launch_stream<false>(XT, X, aux, q, mind, sel, out, nullptr, b, n,
                                d, kind, 0, scratch,
                                static_cast<cudaStream_t>(stream));
}

// The operands of one traversal's recording steps, filled once by the
// caller (kernels/prim_stream.py, StreamRecord): XT (b, d, n) f32 the
// feature-major copy of X (b, n, d) f32, aux (b, n) f32, mind (b, n) f32
// and sel (b, n) bool as bytes updated in place, order (b, n) int64 and
// edges (b, n) f32 the record, scratch of repro_prim_stream_scratch_words(b,
// n) words zeroed before the first step, the stream; then b, n, d and the
// metric kind.
struct ReproStreamRecordArgs {
    const float* XT;
    const float* X;
    const float* aux;
    float* mind;
    unsigned char* sel;
    long long* order;
    float* edges;
    unsigned long long* scratch;
    void* stream;
    long long b, n, d, kind;
};

// Recording step t (1 <= t < n) of each of b lanes, one launch: the pivot is
// order[z, t - 1]; then order[z, t] = the next vertex, edges[z, t] = its
// edge, sel[z, next] = 1.  Two arguments, so that a loop of steps costs the
// host one short call a step.
extern "C" int repro_prim_stream_record(const ReproStreamRecordArgs* a,
                                        int t) {
    return launch_stream<true>(a->XT, a->X, a->aux, nullptr, a->mind, a->sel,
                               a->order, a->edges, static_cast<int>(a->b),
                               static_cast<int>(a->n), static_cast<int>(a->d),
                               static_cast<int>(a->kind), t, a->scratch,
                               static_cast<cudaStream_t>(a->stream));
}

// The operands of one rank's frontier steps, filled once by the caller
// (kernels/prim_stream.py, FrontierStep): XT (d, n) f32 the feature-major
// copy of X (n, d) f32, the shard (global ids offset .. offset + n - 1), aux
// (n,), table (P, W) f32 the gathered slots of the last step (W = 4 + d
// rounded up to a multiple of 4), refilled between steps, mind (n,) f32 the
// in-band frontier, updated in place; order (N,) int64 and edges (N,) f32
// the traversal; scratch of repro_prim_stream_scratch_words(1, n) words
// zeroed before the first step; out (W,) f32 this rank's next slot; the
// stream; then P, W, n, d, the metric kind, offset and N.
struct ReproFrontierStepArgs {
    const float* XT;
    const float* X;
    const float* aux;
    const float* table;
    float* mind;
    long long* order;
    float* edges;
    unsigned long long* scratch;
    float* out;
    void* stream;
    long long P, W, n, d, kind, offset, N;
};

// The sharded engine's step t (0 <= t < N) on one rank, one launch: the
// pivot is recorded at t.
extern "C" int repro_prim_frontier_step(const ReproFrontierStepArgs* a,
                                        int t) {
    if (t >= a->N) return static_cast<int>(cudaErrorInvalidValue);
    return launch_frontier(a->XT, a->X, a->aux, a->table,
                           static_cast<int>(a->P), static_cast<int>(a->W),
                           a->mind, static_cast<int>(a->n),
                           static_cast<int>(a->d), static_cast<int>(a->kind),
                           a->offset, a->order, a->edges, t, a->scratch,
                           a->out, static_cast<cudaStream_t>(a->stream));
}

// Reads count f32 words of x once over every SM (blocks CTAs), for timing:
// the floor a step's read of X is held against.  out receives at most one
// word a CTA, and in practice none.
extern "C" int repro_read_floor(const float* x, long long count, int blocks,
                                unsigned* out, void* stream) {
    if (count < 0 || blocks < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    read_floor_kernel<<<blocks, FLOOR_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, count, out);
    return static_cast<int>(cudaGetLastError());
}
