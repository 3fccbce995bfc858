// Kernel B11: the occupied cells of a (2r+1)^3 window around each queried
// voxel.
//
// Replaces: occupied_neighbor_counts (hifi_fusion_tpu/ops/queries.py:
// 40-60), which radius_outlier_mask (:63-77) runs over every slot of the
// table.  The JAX package looks every window cell up in the hash
// (hashing.lookup, one probe chain per cell) and counts the cells that
// have a slot and a point (n_pts > 0, grid.py occupied_at) and lie inside
// the grid.  The occupancy bitmap holds exactly that set: integrate sets a
// cell's bit when the cell is placed and gets its first point
// (hifi_fusion_tpu/ops/integrate.py:391-401; ops/integrate.py in the
// port), and a cell whose insert failed has neither a slot nor a bit.  So
// this kernel reads the window from the cell-id-keyed bitmap, as K4
// does, and the counts are exact, also when inserts overflowed.  A query
// slot of -1 (or below) counts 0; a slot past the table reads its last
// slot, and an empty slot's key (-1) gives the coordinates the JAX
// package's floor division gives it.
//
// Bound on the card: bytes.  A query reads its slot and writes its count
// (8 B), an answered query reads its key (4 B), and the bitmap words under
// the windows are read once: at the bench grid (2^22 slots, 259,983
// occupied, r = 2) ~34 MB of slots and counts, ~1 MB of keys and the
// distinct window words, ~11 us at 3.35 TB/s.  The windows of
// neighbouring cells overlap, so the 2 x (2r+1)^2 word reads of a query
// mostly hit the L2; their dependent trip after the key read, and the
// queries' scattered slots, set the time more than the bytes do.
//
// Design: a warp per 32 consecutive query slots.  Each lane reads its
// slot (coalesced) and, if it is live, its key: two trips for the whole
// warp.  Then the warp takes its live queries one after another: every
// lane reads the two words of one column of the window at a time (lane
// j takes columns j, j + 32, ...), cuts them to the z window and masks
// them to the grid (common.cuh column_base / column_window /
// z_window_mask), and a warp sum of the popcounts gives the count: one
// trip a live query, and ~30 registers, so the card holds every thread
// it can.  A thread a query with every column's words in its registers
// took 108 registers at r = 2 (a quarter of the threads resident), while
// ~94% of the threads of the ROR call read a -1 and leave: 0.264 ms on
// one H100 at the bench grid (PERF.md).  No f32 arithmetic: the counts
// are exact.

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kMaxK = 15;
constexpr unsigned kFull = 0xffffffffu;

// floor division and modulo by a positive dim, as the JAX package's
// id_to_coords computes them (a key is a dense id >= 0, or -1)
__device__ __forceinline__ int floor_div(int a, int b) {
    const int q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int floor_mod(int a, int b) {
    const int r = a % b;
    return r < 0 ? r + b : r;
}

__global__ void __launch_bounds__(kThreads) neighbor_count_kernel(
    const int* __restrict__ slots, int Q, const int* __restrict__ key, int C,
    const uint32_t* __restrict__ occ_bits, int W, Geo g, int k,
    int* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int q = blockIdx.x * kThreads + threadIdx.x;
    // no lane leaves before the warp's collectives
    const bool in = q < Q;
    const int s = in ? slots[q] : -1;
    const bool live = s >= 0;
    const int id = live ? key[min(s, C - 1)] : 0;
    if (in && !live) out[q] = 0;
    const int S = 2 * k + 1, NC = S * S;
    unsigned todo = __ballot_sync(kFull, live);
    while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1u;
        const int qid = __shfl_sync(kFull, id, src);
        const int cz = floor_mod(qid, g.dims[2]);
        const int xy = floor_div(qid, g.dims[2]);
        const int cy = floor_mod(xy, g.dims[1]);
        const int cx = floor_div(xy, g.dims[1]);
        const uint32_t zmask = z_window_mask(g, cz, k);
        int part = 0;
        for (int c = lane; c < NC; c += 32) {
            const int col = column_base(g, cx, cy, cz, c, S, k, NC);
            if (col < 0) continue;
            const int w0i = min(max(col - k, 0) >> 5, W - 1);
            const uint32_t w0 = __ldg(occ_bits + w0i);
            const uint32_t w1 =
                w0i + 1 < W ? __ldg(occ_bits + w0i + 1) : 0u;
            part += __popc(column_window(w0, w1, col, k, zmask));
        }
        const int total = __reduce_add_sync(kFull, part);
        if (lane == src) out[q] = total;
    }
}

extern "C" int launch_neighbor_count(const void* slots, int Q,
                                     const void* key, int C,
                                     const void* occ_bits, int W,
                                     const float* geo_f, const int* geo_i,
                                     int k, void* out, void* stream) {
    if (k < 0 || k > kMaxK || C <= 0 || W <= 0)
        return (int)cudaErrorInvalidValue;
    if (Q == 0) return 0;
    neighbor_count_kernel<<<grid_blocks(Q, kThreads), kThreads, 0,
                            (cudaStream_t)stream>>>(
        (const int*)slots, Q, (const int*)key, C, (const uint32_t*)occ_bits,
        W, make_geo(geo_f, geo_i), k, (int*)out);
    return (int)cudaGetLastError();
}
