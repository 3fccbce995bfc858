// A device-wide exclusive scan of int32 counts, for kernels B3
// (integrate_lanes.cu) and B6 (refine_lines.cu): reduce, then scan.
//
// The lanes [0, n) are cut into tiles of SCAN_TILE; thread t of a tile's
// block takes SCAN_ITEMS consecutive lanes.  Three launches:
//  1. scan_reduce: each tile's sum of op.count(i) into tile[b];
//  2. scan_tiles (one block): tile[] turned into exclusive offsets in
//     place, and the grand total into *total;
//  3. scan_apply: each tile again; every lane gets its exclusive prefix
//     (the tile's offset plus the block's and the thread's) and calls
//     op.apply(i, prefix, *total).
// ``n`` is a host bound (a budget); a lane past the data's device-side
// length counts 0 (the functor decides).  The total stays on the card:
// nothing is read back.  Op is a by-value functor with
//   __device__ int count(long i) const;
//   __device__ void apply(long i, int prefix, int total) const;
// The kernels are static, so each source that includes this header has
// its own copies.
#pragma once

#include "common.cuh"

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;

// exclusive prefix of v over the block's threads in thread order; the
// block's total into *block_total (every thread sees it)
__device__ __forceinline__ int block_exclusive(int v, int* block_total) {
    __shared__ int warp_sums[32];
    const int wl = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int nw = (blockDim.x + 31) >> 5;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (wl >= o) x += y;
    }
    if (wl == 31) warp_sums[w] = x;
    __syncthreads();
    if (w == 0) {
        int s = wl < nw ? warp_sums[wl] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, s, o);
            if (wl >= o) s += y;
        }
        warp_sums[wl] = s;                       // inclusive over warps
    }
    __syncthreads();
    const int before = w > 0 ? warp_sums[w - 1] : 0;
    *block_total = warp_sums[nw - 1];
    __syncthreads();                             // warp_sums reusable
    return before + x - v;
}

template <class Op>
static __global__ void __launch_bounds__(SCAN_THREADS)
scan_reduce(Op op, long n, int* __restrict__ tile) {
    const long base = (long)blockIdx.x * SCAN_TILE
                      + (long)threadIdx.x * SCAN_ITEMS;
    int s = 0;
    for (int k = 0; k < SCAN_ITEMS; ++k)
        if (base + k < n) s += op.count(base + k);
    int total;
    block_exclusive(s, &total);
    if (threadIdx.x == 0) tile[blockIdx.x] = total;
}

static __global__ void __launch_bounds__(1024)
scan_tiles(int* __restrict__ tile, int nt, int* __restrict__ total) {
    // each thread scans a contiguous run of ceil(nt / 1024) tiles
    const int per = (nt + 1023) / 1024;
    const int lo = min(nt, (int)threadIdx.x * per);
    const int hi = min(nt, lo + per);
    int s = 0;
    for (int i = lo; i < hi; ++i) s += tile[i];
    int all;
    int off = block_exclusive(s, &all);
    for (int i = lo; i < hi; ++i) {
        const int v = tile[i];
        tile[i] = off;
        off += v;
    }
    if (threadIdx.x == 0) *total = all;
}

template <class Op>
static __global__ void __launch_bounds__(SCAN_THREADS)
scan_apply(Op op, long n, const int* __restrict__ tile,
           const int* __restrict__ total) {
    const long base = (long)blockIdx.x * SCAN_TILE
                      + (long)threadIdx.x * SCAN_ITEMS;
    int c[SCAN_ITEMS];
    int s = 0;
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        c[k] = base + k < n ? op.count(base + k) : 0;
        s += c[k];
    }
    int block_total;
    int pre = tile[blockIdx.x] + block_exclusive(s, &block_total);
    const int all = *total;
    for (int k = 0; k < SCAN_ITEMS; ++k) {
        if (base + k < n) op.apply(base + k, pre, all);
        pre += c[k];
    }
}

// The three launches over n lanes; ``tile`` holds scan_tiles_needed(n)
// ints of scratch, ``total`` one.
static inline int scan_tiles_needed(long n) {
    return grid_blocks(n, SCAN_TILE);
}

template <class Op>
static inline void device_scan(const Op& op, long n, int* tile, int* total,
                               cudaStream_t st) {
    const int nt = scan_tiles_needed(n);
    scan_reduce<Op><<<nt, SCAN_THREADS, 0, st>>>(op, n, tile);
    scan_tiles<<<1, 1024, 0, st>>>(tile, nt, total);
    scan_apply<Op><<<nt, SCAN_THREADS, 0, st>>>(op, n, tile, total);
}
