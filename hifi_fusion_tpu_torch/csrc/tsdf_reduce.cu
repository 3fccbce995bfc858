// Kernel T4: the TSDF batch reduce's runs, compaction and scatter, on a
// batch's sample lanes sorted by cell id.
//
// Replaces: _tsdf_reduce in hifi_fusion_tpu/models/tsdf.py :135-182 after
// its sort and segment scan: the run starts and ends of the sorted ids,
// the first U runs' ids and six-channel sums compacted (argsort(~starts)
// [:U], argsort(~ends)[:U]), overflow_unique += max(n_u - U, 0), the
// find-or-insert of those ids and one add of each placed cell's sums into
// vstats.  In the port's plain version (models/tsdf.py tsdf_reduce_plain)
// the compaction is two torch.nonzero calls and a count, each a read back
// to the host; here every count stays on the card.
//
// Input: the M sorted ids (INVALID_ID = INT32_MAX last) and T1's (6, M)
// inclusive segmented sums in the same lane order (ops/scatter.py
// segment_sums), which hold each run's total at its last lane.
//
// Bound on the card: memory.  The sorted ids are read once (4 B a lane);
// per compacted run its end lane's six sums (24 B), its key probe and,
// for a new cell, the key written (K2); per placed cell its six vstats
// words read and written (48 B): bounds.tsdf_reduce.
//
// Design: a memset and one launch before K2, one launch after it, no host
// read (launch_tsdf_reduce_runs, launch_tsdf_reduce_scatter):
//  0. one cudaMemsetAsync zeroes the scratch: the live count and the run
//     scan's tile counter and look-back words;
//  1. the runs pass, a thread a lane in tiles of RUN_SCAN_TILE lanes
//     (csrc/scan.cuh: a block a tile, the tiles' run counts chained by
//     decoupled look-back).  A valid lane whose id differs from its
//     predecessor's starts a run; its run index r is the count of starts
//     up to it, less one.  A tile gathers its run starts' ids and its run
//     ends' lanes (a lane whose successor holds another id) in run order
//     in shared memory, and once its count of earlier runs is known
//     writes, for each run r < U, uids[r] and usums[:, r] from the sums
//     at the run's last lane, a thread a run: consecutive runs to
//     consecutive words (a thread a lane would write one word in twenty
//     of a warp's).  These are the JAX package's first U starts and first
//     U ends, which pair up run by run because the invalid lanes sort
//     last.  The last valid lane's run is n_u - 1: its thread writes the
//     live count min(n_u, U) and adds max(n_u - U, 0) into
//     overflow_unique; with no valid lane the live count stays 0.  The
//     end lanes' sums are read a word from a 32-byte sector each (runs
//     average ~22 lanes), ~240 MB of sectors at phase 3's shape.
// Then K2 finds or inserts uids[0, live) (hashing.lookup_or_insert with
// the live count; it touches no lane past it), adding its failures into
// overflow_probe.  After it:
//  2. the scatter, a thread a compacted run r < live: where its slot is
//     placed (>= 0) it adds the six sums into vstats[6 slot, 6 slot + 6).
//     The run ids are distinct, so their slots are: one plain
//     read-add-write of the 24-byte row (a 16-byte and an 8-byte access),
//     no atomics, and each cell's words take one f32 add, as index_add_
//     and the JAX package's scatter_add do, so vstats is theirs bit for
//     bit.  The rows are random in a 400 MB array: random sectors bound
//     it.
// K2's slots may differ from the plain version's (its CAS race against
// the first-in-input-order election); the grid is the same by cell id.

#include "scan.cuh"

static __global__ void __launch_bounds__(SCAN_THREADS)
t4_runs_kernel(const int* __restrict__ sid, int M, int U, int tiles,
               const float* __restrict__ sums6, int* __restrict__ uids,
               float* __restrict__ usums, int* __restrict__ n_live,
               int* __restrict__ overflow_unique,
               int* __restrict__ scratch) {
    // the tile's run ids in run order, and its runs' last lanes: entry j
    // for the tile's j-th run end, entry 0 for a run begun in an earlier
    // tile (-1 where that run does not end in this tile)
    __shared__ int start_id[RUN_SCAN_TILE];
    __shared__ int end_lane[RUN_SCAN_TILE + 1];
    const LookBack lb(scratch, tiles);
    const int tile = next_tile(lb.counter);
    const int base = tile * RUN_SCAN_TILE + (int)threadIdx.x;
    int id[RUN_SCAN_ITEMS], head[RUN_SCAN_ITEMS], run[RUN_SCAN_ITEMS];
#pragma unroll
    for (int k = 0; k < RUN_SCAN_ITEMS; ++k) {
        const int i = base + k * SCAN_THREADS;
        id[k] = i < M ? sid[i] : INVALID_ID;
        const int prev = i > 0 && i < M ? sid[i - 1] : INVALID_ID;
        head[k] = id[k] != INVALID_ID && id[k] != prev;
        run[k] = head[k];
    }
    const int agg = tile_scan(SumOp(), run);
    // the two runs that may not end in this tile
    if (threadIdx.x == 0) end_lane[0] = end_lane[agg] = -1;
    __syncthreads();
    // run[k]: the tile's runs begun up to lane (k, t); a lane before the
    // tile's first start continues the run begun before the tile
#pragma unroll
    for (int k = 0; k < RUN_SCAN_ITEMS; ++k) {
        const int i = base + k * SCAN_THREADS;
        if (i >= M || id[k] == INVALID_ID) continue;
        if (head[k]) start_id[run[k] - 1] = id[k];
        const int next = i + 1 < M ? sid[i + 1] : INVALID_ID;
        if (next != id[k]) end_lane[run[k]] = i;
    }
    const int before = tile_prefix(lb, tile, agg);   // syncs the block
    // the run starts: runs before + j, j < agg, in order
    for (int j = threadIdx.x; j < agg && before + j < U;
         j += SCAN_THREADS)
        uids[before + j] = start_id[j];
    // the run ends: run before - 1 + j; the last valid lane of the batch
    // ends run n_u - 1
    for (int j = threadIdx.x; j <= agg; j += SCAN_THREADS) {
        const int i = end_lane[j];
        const int r = before - 1 + j;
        if (i < 0 || r >= U) {
            if (i >= 0 && (i + 1 == M || sid[i + 1] == INVALID_ID)) {
                *n_live = U;
                *overflow_unique += r + 1 - U;
            }
            continue;
        }
#pragma unroll
        for (int c = 0; c < 6; ++c)
            usums[(long)c * U + r] = sums6[(long)c * M + i];
        if (i + 1 == M || sid[i + 1] == INVALID_ID) *n_live = r + 1;
    }
}

static __global__ void t4_scatter_kernel(int U, const int* __restrict__
                                         n_live,
                                         const int* __restrict__ uslot,
                                         const float* __restrict__ usums,
                                         float* __restrict__ vstats) {
    const int n = *n_live;
    for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n;
         r += gridDim.x * blockDim.x) {
        const int s = uslot[r];
        if (s < 0) continue;                    // the probe bound failed
        float v[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) v[c] = usums[(long)c * U + r];
        // a row is 24 bytes at 8-byte alignment: a 16-byte and an 8-byte
        // access, in the order its alignment allows
        float* row = vstats + 6L * s;
        if ((s & 1) == 0) {
            float4 a = *reinterpret_cast<float4*>(row);
            float2 b = *reinterpret_cast<float2*>(row + 4);
            a.x = __fadd_rn(a.x, v[0]);
            a.y = __fadd_rn(a.y, v[1]);
            a.z = __fadd_rn(a.z, v[2]);
            a.w = __fadd_rn(a.w, v[3]);
            b.x = __fadd_rn(b.x, v[4]);
            b.y = __fadd_rn(b.y, v[5]);
            *reinterpret_cast<float4*>(row) = a;
            *reinterpret_cast<float2*>(row + 4) = b;
        } else {
            float2 a = *reinterpret_cast<float2*>(row);
            float4 b = *reinterpret_cast<float4*>(row + 2);
            a.x = __fadd_rn(a.x, v[0]);
            a.y = __fadd_rn(a.y, v[1]);
            b.x = __fadd_rn(b.x, v[2]);
            b.y = __fadd_rn(b.y, v[3]);
            b.z = __fadd_rn(b.z, v[4]);
            b.w = __fadd_rn(b.w, v[5]);
            *reinterpret_cast<float2*>(row) = a;
            *reinterpret_cast<float4*>(row + 2) = b;
        }
    }
}

static inline long t4_scratch_words(int M) {
    return 2 + lookback_words(M, RUN_SCAN_TILE);
}

// Before K2: the memset and the runs pass.  ``scratch`` holds
// t4_scratch_words(M) ints: [live count, pad, the run scan's look-back].
extern "C" int launch_tsdf_reduce_runs(const void* sid, int M, int U,
                                       const void* sums6, void* uids,
                                       void* usums, void* overflow_unique,
                                       void* scratch, long words,
                                       void* stream) {
    if (words < t4_scratch_words(M)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    int* sc = (int*)scratch;
    const cudaError_t e =
        cudaMemsetAsync(sc, 0, t4_scratch_words(M) * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    if (M > 0) {
        const int tiles = grid_blocks(M, RUN_SCAN_TILE);
        t4_runs_kernel<<<tiles, SCAN_THREADS, 0, st>>>(
            (const int*)sid, M, U, tiles, (const float*)sums6, (int*)uids,
            (float*)usums, sc, (int*)overflow_unique, sc + 2);
    }
    return (int)cudaGetLastError();
}

// After K2 (uslot): the scatter of the live runs' sums into vstats.
extern "C" int launch_tsdf_reduce_scatter(int U, const void* scratch,
                                          const void* uslot,
                                          const void* usums, void* vstats,
                                          void* stream) {
    if (U == 0) return 0;
    constexpr int threads = 256;
    t4_scatter_kernel<<<grid_blocks(U, threads), threads, 0,
                        (cudaStream_t)stream>>>(
        U, (const int*)scratch, (const int*)uslot, (const float*)usums,
        (float*)vstats);
    return (int)cudaGetLastError();
}
