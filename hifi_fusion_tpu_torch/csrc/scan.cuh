// Single-pass tile scans with decoupled look-back, for kernels B3
// (integrate_lanes.cu) and B6 (refine_lines.cu), and the run scan both
// share: the runs of equal ids in a sorted id array.
//
// A scan kernel cuts its lanes [0, n) into tiles of ITEMS * SCAN_THREADS
// lanes, a block a tile; lane (k, t) of a tile, for item k < ITEMS and
// thread t, is tile * ITEMS * SCAN_THREADS + k * SCAN_THREADS + t, so
// every load and store of a round k is coalesced.  A block takes its tile
// index from an atomic counter (next_tile), so a tile only ever waits on
// tiles whose blocks are already running.  It scans its lanes in
// registers and shared memory (tile_scan: a warp-shuffle scan of each
// round, then of the warps' totals), publishes its count, looks back
// over its predecessors' counts and inclusive prefixes until it meets an
// inclusive prefix (tile_prefix), and publishes its own inclusive prefix.
// Only counts cross tiles: B3 keeps its colour sums inside a tile.
//
// The look-back reads LOOKBACK_WINDOW predecessors a round with the whole
// block: while the first tiles of a call are still resolving, the tiles
// running beside them find only aggregates, and the frontier of
// inclusive prefixes advances by a window each round trip to L2.  Each
// published count travels as one 64-bit word with a "written" flag in
// its high half, stored and loaded with relaxed gpu-scope operations
// (st/ld.relaxed.gpu: through L2, single-copy atomic), and aggregates
// and inclusive prefixes have words of their own, so no fence orders a
// value before its flag and no acquire load empties the SM's L1 while
// the other blocks gather through it.  A spin that finds a tile not yet
// published backs off with __nanosleep.  The words and the tile counter
// live in the caller's scratch, which the launcher zeroes on the stream
// (cudaMemsetAsync) before the first scan of a call: nothing is read
// back to the host.
//
// tile_scan's Op is a by-value functor over a plain struct T of 32-bit
// words:
//   using T = ...;
//   static __device__ T identity();
//   __device__ T operator()(const T& earlier, const T& later) const;
// associative, not necessarily commutative (B3's segmented sums are not).
// The kernels are static, so each source that includes this header has
// its own copies.
#pragma once

#include <string.h>

#include "common.cuh"

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr unsigned long long WRITTEN = 1ull << 32;

// ints of scratch a look-back count scan over n lanes in tiles of
// ``tile`` lanes needs, 8-byte aligned where the scan's part of the
// scratch starts: the tile counter, then each tile's aggregate and
// inclusive prefix, 64-bit words (kernels/__init__.py lookback_words)
static inline long lookback_words(long n, int tile) {
    return 2 * (1 + 2L * grid_blocks(n, tile));
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
    asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

__device__ __forceinline__ unsigned long long load_relaxed(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
    return v;
}

template <class T>
__device__ __forceinline__ T shfl_up_t(const T& v, int d) {
    static_assert(sizeof(T) % 4 == 0, "scan values are 32-bit words");
    int w[sizeof(T) / 4];
    memcpy(w, &v, sizeof(T));
#pragma unroll
    for (int i = 0; i < (int)(sizeof(T) / 4); ++i)
        w[i] = __shfl_up_sync(FULL_MASK, w[i], d);
    T r;
    memcpy(&r, w, sizeof(T));
    return r;
}

struct SumOp {
    using T = int;
    static __device__ __forceinline__ int identity() { return 0; }
    __device__ __forceinline__ int operator()(int a, int b) const {
        return a + b;
    }
};

// the tile index of this block, in the order blocks start
__device__ __forceinline__ int next_tile(unsigned long long* counter) {
    __shared__ int tile;
    if (threadIdx.x == 0) tile = (int)atomicAdd(counter, 1ull);
    __syncthreads();
    return tile;
}

// In-place scan of a tile's ITEMS * SCAN_THREADS values, v[k] the value of
// lane (k, t): v[k] becomes the combination of the tile's lanes up to and
// including lane (k, t) (lane order); returns the whole tile's.  Every
// thread of the block calls it.
template <class Op, int ITEMS>
__device__ __forceinline__ typename Op::T tile_scan(
        const Op& op, typename Op::T (&v)[ITEMS]) {
    using T = typename Op::T;
    __shared__ T sh[SCAN_WARPS * ITEMS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
            const T y = shfl_up_t(v[k], d);
            if (lane >= d) v[k] = op(y, v[k]);
        }
    }
    if (lane == 31) {
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) sh[warp * ITEMS + k] = v[k];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) {
            T w = lane < SCAN_WARPS ? sh[lane * ITEMS + k]
                                    : Op::identity();
#pragma unroll
            for (int d = 1; d < SCAN_WARPS; d <<= 1) {
                const T y = shfl_up_t(w, d);
                if (lane >= d) w = op(y, w);
            }
            if (lane < SCAN_WARPS) sh[lane * ITEMS + k] = w;
        }
    }
    __syncthreads();
    T rounds = Op::identity();          // the rounds before round k
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        if (warp > 0) v[k] = op(sh[(warp - 1) * ITEMS + k], v[k]);
        v[k] = op(rounds, v[k]);
        rounds = op(rounds, sh[(SCAN_WARPS - 1) * ITEMS + k]);
    }
    __syncthreads();
    return rounds;
}

// The look-back state of one count scan in the caller's zeroed scratch
// (8-byte aligned): the tile counter, then each tile's aggregate, then
// each tile's inclusive prefix, one flagged 64-bit word each.
struct LookBack {
    unsigned long long* counter;
    unsigned long long* agg;
    unsigned long long* incl;
    __device__ LookBack(int* scratch, int tiles)
        : counter(reinterpret_cast<unsigned long long*>(scratch)),
          agg(counter + 1), incl(counter + 1 + tiles) {}

    __device__ void publish_aggregate(int tile, int v) const {
        store_relaxed(agg + tile, WRITTEN | (unsigned)v);
    }

    __device__ void publish_inclusive(int tile, int v) const {
        store_relaxed(incl + tile, WRITTEN | (unsigned)v);
    }

    // tile t's count into v: 2 for its inclusive prefix, 1 for its
    // aggregate, 0 (v unset) when neither is published yet
    __device__ int read(int t, int& v) const {
        unsigned long long x = load_relaxed(incl + t);
        if (x & WRITTEN) {
            v = (int)(unsigned)x;
            return 2;
        }
        x = load_relaxed(agg + t);
        v = (int)(unsigned)x;
        return (x & WRITTEN) ? 1 : 0;
    }
};

// predecessors a thread reads in each round of the look-back
constexpr int LOOKBACK_ITEMS = 2;
constexpr int LOOKBACK_WINDOW = SCAN_THREADS * LOOKBACK_ITEMS;

// The count of every lane before tile ``tile`` (the tile's exclusive
// prefix), given the tile's own count ``agg``: publishes the aggregate
// (a caller may have published it earlier; the word is the same), looks
// back over LOOKBACK_WINDOW predecessors a round with the whole block
// (thread i reads the tiles at distances i + m * SCAN_THREADS), adds the
// counts nearer than the nearest inclusive prefix and that prefix,
// publishes its own inclusive prefix and returns the exclusive one to
// every thread.
__device__ __forceinline__ int tile_prefix(const LookBack& lb, int tile,
                                           int agg) {
    __shared__ int warp_stop[SCAN_WARPS];
    __shared__ int warp_sum[SCAN_WARPS];
    __shared__ int shared_pre;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (tile == 0) {
        if (threadIdx.x == 0) {
            lb.publish_inclusive(0, agg);
            shared_pre = 0;
        }
        __syncthreads();
        return shared_pre;
    }
    if (threadIdx.x == 0) lb.publish_aggregate(tile, agg);
    int pre = 0;                        // thread 0's: the rounds so far
    for (int last = tile - 1;; last -= LOOKBACK_WINDOW) {
        int v[LOOKBACK_ITEMS], state[LOOKBACK_ITEMS];
        for (unsigned ns = 32;; ns = ns < 1024 ? 2 * ns : ns) {
            bool waiting = false;
#pragma unroll
            for (int m = 0; m < LOOKBACK_ITEMS; ++m) {
                // tile 0 always holds an inclusive prefix, so a tile past
                // it (t < 0) is never reached
                const int t = last - (int)threadIdx.x - m * SCAN_THREADS;
                state[m] = t >= 0 ? lb.read(t, v[m]) : 2;
                if (t < 0) v[m] = 0;
                waiting = waiting || state[m] == 0;
            }
            if (!__syncthreads_or(waiting)) break;
            __nanosleep(ns);
        }
        // the nearest inclusive prefix ends the walk
        int near = LOOKBACK_WINDOW;
#pragma unroll
        for (int m = LOOKBACK_ITEMS - 1; m >= 0; --m)
            if (state[m] == 2) near = (int)threadIdx.x + m * SCAN_THREADS;
        near = (int)__reduce_min_sync(FULL_MASK, (unsigned)near);
        if (lane == 0) warp_stop[warp] = near;
        __syncthreads();
        int stop = LOOKBACK_WINDOW;
#pragma unroll
        for (int w = 0; w < SCAN_WARPS; ++w) stop = min(stop, warp_stop[w]);
        int sum = 0;
#pragma unroll
        for (int m = 0; m < LOOKBACK_ITEMS; ++m)
            if ((int)threadIdx.x + m * SCAN_THREADS <= stop) sum += v[m];
        sum = __reduce_add_sync(FULL_MASK, sum);
        if (lane == 0) warp_sum[warp] = sum;
        __syncthreads();
        if (threadIdx.x == 0)
            for (int w = 0; w < SCAN_WARPS; ++w) pre += warp_sum[w];
        if (stop < LOOKBACK_WINDOW) break;
        __syncthreads();                // warp_stop and warp_sum reused
    }
    if (threadIdx.x == 0) {
        lb.publish_inclusive(tile, pre + agg);
        shared_pre = pre;
    }
    __syncthreads();
    return shared_pre;
}

// warp: the valid lanes of the sorted ids[0, M) past the budget NA (the
// first INVALID_ID lane, found by 32-way search, minus NA) plus
// ``extra`` into *overflow (B3's overflow_active)
__device__ __forceinline__ void count_past_budget(const int* ids, long M,
                                                  long NA, int extra,
                                                  int* overflow) {
    const int lane = threadIdx.x & 31;
    long over = 0;
    if (NA < M && (NA == 0 || ids[NA - 1] != INVALID_ID)) {
        // the first invalid lane a lies in [lo, hi]; lanes before lo are
        // valid; a probe at or past hi counts as invalid
        long lo = NA, hi = M;
        while (lo < hi) {
            const long step = (hi - lo + 31) / 32;
            const long p = lo + lane * step;
            const unsigned b =
                __ballot_sync(FULL_MASK, p >= hi || ids[p] == INVALID_ID);
            if (b == 0) {
                lo += 31 * step + 1;
                continue;
            }
            const int k = __ffs(b) - 1;
            if (k == 0) break;                   // a == lo
            const long nlo = lo + (long)(k - 1) * step + 1;
            hi = min(lo + (long)k * step, hi);
            lo = nlo;
        }
        over = lo - NA;
    }
    if (lane == 0 && over + extra != 0) *overflow += (int)over + extra;
}

// The run scan over the first NA lanes of sorted ids (INVALID_ID last):
// every valid lane gets its run u in lane_run (-1 for an invalid lane),
// each run start writes the run's id and first lane (uids[u], ustart[u]),
// the last valid lane writes ustart[U] = n_valid and *n_runs = U (left 0
// by the scratch's memset when no lane is valid).  With ``overflow``, the
// last tile's warp 0 adds the valid lanes of ids[NA, M) and ``extra``
// into it.
// the run scan's lanes a thread and a tile (kernels/__init__.py
// RUN_SCAN_TILE): few tiles, so that a tile's look-back reaches an
// inclusive prefix in one round
constexpr int RUN_SCAN_ITEMS = 16;
constexpr int RUN_SCAN_TILE = RUN_SCAN_ITEMS * SCAN_THREADS;

static __global__ void __launch_bounds__(SCAN_THREADS)
run_scan_kernel(const int* __restrict__ ids, long M, long NA, int tiles,
                int extra, int* __restrict__ overflow,
                int* __restrict__ lane_run, int* __restrict__ uids,
                int* __restrict__ ustart, int* __restrict__ n_runs,
                int* __restrict__ scratch) {
    const LookBack lb(scratch, tiles);
    const int tile = next_tile(lb.counter);
    const long base = (long)tile * RUN_SCAN_TILE + threadIdx.x;
    int id[RUN_SCAN_ITEMS], head[RUN_SCAN_ITEMS];
#pragma unroll
    for (int k = 0; k < RUN_SCAN_ITEMS; ++k) {
        const long i = base + k * SCAN_THREADS;
        id[k] = i < NA ? ids[i] : INVALID_ID;
        const int prev = i > 0 && i < NA ? ids[i - 1] : INVALID_ID;
        head[k] = id[k] != INVALID_ID && id[k] != prev;
    }
    int run[RUN_SCAN_ITEMS];
#pragma unroll
    for (int k = 0; k < RUN_SCAN_ITEMS; ++k) run[k] = head[k];
    const int agg = tile_scan(SumOp(), run);
    const int before = tile_prefix(lb, tile, agg);
#pragma unroll
    for (int k = 0; k < RUN_SCAN_ITEMS; ++k) {
        const long i = base + k * SCAN_THREADS;
        if (i >= NA) continue;
        if (id[k] == INVALID_ID) {
            lane_run[i] = -1;
            continue;
        }
        const int u = before + run[k] - 1;
        lane_run[i] = u;
        if (head[k]) {
            uids[u] = id[k];
            ustart[u] = (int)i;
        }
        if (i + 1 == NA || ids[i + 1] == INVALID_ID) {
            ustart[u + 1] = (int)(i + 1);
            *n_runs = u + 1;
        }
    }
    if (overflow != nullptr && tile == tiles - 1 && threadIdx.x < 32)
        count_past_budget(ids, M, NA, extra, overflow);
}

// One launch of the run scan; ``scratch`` holds lookback_words(NA,
// RUN_SCAN_TILE) zeroed ints, 8-byte aligned.
static inline void run_scan(const int* ids, long M, long NA, int extra,
                            int* overflow, int* lane_run, int* uids,
                            int* ustart, int* n_runs, int* scratch,
                            cudaStream_t st) {
    const int tiles = grid_blocks(NA, RUN_SCAN_TILE);
    run_scan_kernel<<<tiles, SCAN_THREADS, 0, st>>>(
        ids, M, NA, tiles, extra, overflow, lane_run, uids, ustart, n_runs,
        scratch);
}
