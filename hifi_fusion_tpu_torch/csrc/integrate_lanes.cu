// Kernel B3: the per-cell aggregation and the buffer append of a fusion
// batch, on its lanes sorted by cell id.
//
// Replaces: integrate_frame_impl in hifi_fusion_tpu/ops/integrate.py
// :339-458: the compaction of the unique cells, the per-unique sums, the
// viewpoint stamp, the occupancy-bitmap OR and the pre-normal buffer
// append.  There they are a payload sort, segment scans, end-position
// compactions and unique-index scatters under static lane budgets; in the
// port's plain version (ops/integrate.py aggregate_lanes_plain) they are
// eager ops whose shapes depend on the data, so the host read counts back
// several times a batch.  Here every count stays on the card and every
// array is sized by the batch's active-lane budget NA.
//
// Input: the first NA lanes of the batch's ids sorted stably (the library
// sort stays, as the JAX package keeps lax.sort) and the sort's lane
// order; the frontend's world points and colour in frame-major lane order
// and the (K,4,4) poses.
//
// Bound on the card: memory.  Per lane the sorted id and order are read
// and the world point (and colour) gathered; per cell a key probe, the
// n_pts, normal_found and rgb_sum words, the viewpoint of a first
// occupancy and an occupancy word; the sorted points and slots K3 reads
// next and the appended buffer lanes are written: 135 MB at the bench's
// third K=8 batch (bounds.integrate_lanes, chip_smoke.py phase 3).  The
// gathers of the world points and colour in sorted order are most of the
// work: each 4-byte lane reads a 32-byte sector of a frame-major array.
//
// Design: three launches and a memset around K2, no host read, every lane
// a thread of a tile (csrc/scan.cuh: a block a tile, the tiles' counts
// chained by decoupled look-back, so each pass reads its lanes once).
// Before K2 (launch_integrate_lanes_cells):
//  0. one cudaMemsetAsync zeroes the scratch: U, the wanted total and the
//     two scans' tile counters and look-back words;
//  1. pass A, scan.cuh's run scan over the NA sorted lanes: each valid
//     lane gets its run u, each run start writes the run's id and first
//     lane (uids[u], ustart[u]), the last valid lane ustart[U] = n_sv and
//     U into scratch[0]; the last tile's warp 0 finds n_act, the first
//     INVALID lane of the whole sorted batch, by a 32-way search past NA
//     and adds max(n_act - NA, 0) plus the router's drops into
//     overflow_active.
// Then K2 finds or inserts the run ids (hashing.lookup_or_insert), given
// the NA-lane array and the device's U as its live count, so it touches
// only the U ids.  After it (launch_integrate_lanes_append):
//  2. pass B, a thread a lane.  The lanes' slots and the wanted flags
//     (placed, no normal yet) come first: the count of wanted lanes is the
//     scan the tiles chain, and a tile publishes its count before its
//     gathers, so that its successors' look-back overlaps them.  Each
//     lane then gathers its world point and colour once and writes the
//     sorted point and slot that K3 streams (slot -1 past n_sv and for an
//     unplaced cell).  A wanted lane's rank is its place among the wanted
//     lanes in sorted-lane order, the plain version's pts[:, want] order;
//     it is appended at buf_count + rank when buf_count + NA <= B (all or
//     nothing; every tile reads buf_count before the finish may change
//     it).  A run's first lane adds the run's length (ustart[u + 1] -
//     ustart[u]) into n_pts, stamps its own frame's viewpoint (the run's
//     earliest frame) where the cell held no point, and sets the cell's
//     bitmap bit with atomicOr; no other lane writes those words, the run
//     ids being distinct.  The colour sums are a segmented scan inside the
//     tile: a run that lies in one tile is added into rgb_sum by its last
//     lane, its only writer; each piece of a run that crosses a tile
//     boundary is added by the piece's last lane with atomicAdd.  The sums
//     are integer-valued f32, exact in any order and grouping while a
//     cell's channel sum stays below 2^24 (65,793 lanes of colour 255),
//     the plain version's limit too, so the grid is the plain version's
//     bit for bit and the same in every run;
//  3. finish: one thread adds the wanted total to buf_count, or to
//     overflow_buf when the batch did not fit.
// The slots K2 hands out may differ from the plain version's (the CAS race
// against its first-in-input-order election); everything else is equal,
// compared by cell id.

#include "scan.cuh"

// a lane's colour sums since the last run start within its tile
// (segmented: a run start resets them)
constexpr unsigned RUN_START = 1u;

struct RunRgb {
    unsigned start;     // RUN_START: the lanes hold a run start
    float r, g, b;
};

struct RunRgbOp {
    using T = RunRgb;
    static __device__ __forceinline__ T identity() {
        return {0u, 0.0f, 0.0f, 0.0f};
    }
    __device__ __forceinline__ T operator()(const T& a, const T& b) const {
        if (b.start) return b;
        return {a.start, __fadd_rn(a.r, b.r), __fadd_rn(a.g, b.g),
                __fadd_rn(a.b, b.b)};
    }
};

// pass B's lanes a thread and a tile (kernels/__init__.py B3_TILE): with
// two, 64 registers a thread and four blocks an SM keep enough gathers in
// flight; four lanes a thread took 112 registers, two blocks an SM, and
// ran the pass in 0.16 ms against 0.13 at the bench's third batch (one
// H100 80GB HBM3, 700 W)
constexpr int B3_ITEMS = 2;
constexpr int B3_TILE = B3_ITEMS * SCAN_THREADS;

// the scratch's ints: [U, n_want, pass A's look-back, pass B's]
static inline long b3_scratch_words(long NA) {
    return 2 + lookback_words(NA, RUN_SCAN_TILE)
           + lookback_words(NA, B3_TILE);
}

struct Grid3 {
    float* n_pts;
    const unsigned char* normal_found;
    float* rgb_sum;
    float* viewpoint;
    unsigned* occ_bits;
};

constexpr int LANE_STARTS_RUN = 1, LANE_ENDS_RUN = 2, LANE_WANTED = 4;

__global__ void __launch_bounds__(SCAN_THREADS)
b3_lanes_kernel(long NA, long M, int N, int tiles,
                const int* __restrict__ lane_run,
                const int* __restrict__ uids, const int* __restrict__ ustart,
                const int* __restrict__ uslot,
                const long* __restrict__ order,
                const float* __restrict__ world,
                const float* __restrict__ rgb,
                const float* __restrict__ poses, int store_color, Grid3 g,
                float* __restrict__ pts, int* __restrict__ slot_pt,
                float* __restrict__ buf_pts, int* __restrict__ buf_slot,
                const int* __restrict__ buf_count, long B,
                int* __restrict__ n_want, int* __restrict__ scratch) {
    const LookBack lb(scratch, tiles);
    const int tile = next_tile(lb.counter);
    const long tile_base = (long)tile * B3_TILE;
    const long base = tile_base + threadIdx.x;
    const long bc = *buf_count;
    int u[B3_ITEMS], s[B3_ITEMS], flags[B3_ITEMS], want[B3_ITEMS];
    long o[B3_ITEMS];
    // the lanes' runs, order and slots, then the wanted lanes: their count
    // is the scan the tiles chain, published before the gathers
#pragma unroll
    for (int k = 0; k < B3_ITEMS; ++k) {
        const long i = base + k * SCAN_THREADS;
        u[k] = i < NA ? lane_run[i] : -1;
        const int prev = i > 0 && i < NA ? lane_run[i - 1] : -1;
        const int next = i + 1 < NA ? lane_run[i + 1] : -1;
        flags[k] = u[k] < 0 ? 0
                   : (prev != u[k] ? LANE_STARTS_RUN : 0)
                     | (next != u[k] ? LANE_ENDS_RUN : 0);
        o[k] = u[k] >= 0 ? order[i] : 0;
    }
#pragma unroll
    for (int k = 0; k < B3_ITEMS; ++k) s[k] = u[k] >= 0 ? uslot[u[k]] : -1;
#pragma unroll
    for (int k = 0; k < B3_ITEMS; ++k) {
        want[k] = s[k] >= 0 && g.normal_found[s[k]] == 0;
        if (want[k]) flags[k] |= LANE_WANTED;
    }
    const int n_tile = tile_scan(SumOp(), want);     // want: tile-inclusive
    if (threadIdx.x == 0 && tile > 0) lb.publish_aggregate(tile, n_tile);
    // the gathers: each lane's world point and colour, once
    float p[B3_ITEMS][3];
    RunRgb c[B3_ITEMS];
#pragma unroll
    for (int k = 0; k < B3_ITEMS; ++k) {
        for (int a = 0; a < 3; ++a)
            p[k][a] = u[k] >= 0 ? world[a * M + o[k]] : 0.0f;
        c[k] = RunRgbOp::identity();
        if (flags[k] & LANE_STARTS_RUN) c[k].start = RUN_START;
        if (store_color && u[k] >= 0) {
            c[k].r = rgb[o[k]];
            c[k].g = rgb[M + o[k]];
            c[k].b = rgb[2 * M + o[k]];
        }
    }
#pragma unroll
    for (int k = 0; k < B3_ITEMS; ++k) {
        const long i = base + k * SCAN_THREADS;
        if (i < NA) {
            for (int a = 0; a < 3; ++a) pts[a * NA + i] = p[k][a];
            slot_pt[i] = s[k];
        }
    }
    if (store_color) tile_scan(RunRgbOp(), c);       // c: within the tile
    const int before = tile_prefix(lb, tile, n_tile);
    if (tile == tiles - 1 && threadIdx.x == 0) *n_want = before + n_tile;
    // the cells: a run's first lane adds its count and stamps the
    // viewpoint, the last lane of each of its pieces in a tile its colour
    float n0[B3_ITEMS], vp[B3_ITEMS][3], sums[B3_ITEMS][3];
    int len[B3_ITEMS], id[B3_ITEMS];
#pragma unroll
    for (int k = 0; k < B3_ITEMS; ++k) {
        const long i = base + k * SCAN_THREADS;
        if (s[k] < 0) continue;
        if (flags[k] & LANE_STARTS_RUN) {
            n0[k] = g.n_pts[s[k]];
            len[k] = ustart[u[k] + 1] - (int)i;
            id[k] = uids[u[k]];
            const float* T = poses + 16L * ((unsigned)o[k] / (unsigned)N);
            for (int a = 0; a < 3; ++a) vp[k][a] = T[4 * a + 3];
        }
        if (store_color && (flags[k] & LANE_ENDS_RUN) && c[k].start)
            for (int a = 0; a < 3; ++a) sums[k][a] = g.rgb_sum[3L * s[k] + a];
    }
    const bool fits = bc + NA <= B;
#pragma unroll
    for (int k = 0; k < B3_ITEMS; ++k) {
        const long i = base + k * SCAN_THREADS;
        if ((flags[k] & LANE_WANTED) && fits) {
            const long at = bc + before + want[k] - 1;
            for (int a = 0; a < 3; ++a) buf_pts[a * B + at] = p[k][a];
            buf_slot[at] = s[k];
        }
        if (s[k] < 0) continue;
        const long cs = 3L * s[k];
        if (flags[k] & LANE_STARTS_RUN) {
            g.n_pts[s[k]] = __fadd_rn(n0[k], (float)len[k]);
            if (!(n0[k] > 0.0f))
                for (int a = 0; a < 3; ++a) g.viewpoint[cs + a] = vp[k][a];
            atomicOr(g.occ_bits + (id[k] >> 5), 1u << (id[k] & 31));
        }
        if (!store_color) continue;
        const bool piece_ends =
            (flags[k] & LANE_ENDS_RUN) || i == tile_base + B3_TILE - 1;
        if (!piece_ends) continue;
        if ((flags[k] & LANE_ENDS_RUN) && c[k].start) {
            // the whole run lies in this tile: its one writer
            g.rgb_sum[cs] = __fadd_rn(sums[k][0], c[k].r);
            g.rgb_sum[cs + 1] = __fadd_rn(sums[k][1], c[k].g);
            g.rgb_sum[cs + 2] = __fadd_rn(sums[k][2], c[k].b);
        } else {
            // a piece of a run that crosses a tile boundary
            atomicAdd(g.rgb_sum + cs, c[k].r);
            atomicAdd(g.rgb_sum + cs + 1, c[k].g);
            atomicAdd(g.rgb_sum + cs + 2, c[k].b);
        }
    }
}

__global__ void b3_finish_kernel(const int* __restrict__ n_want, long NA,
                                 long B, int* __restrict__ buf_count,
                                 int* __restrict__ overflow_buf) {
    if (*buf_count + NA <= B) *buf_count += *n_want;
    else *overflow_buf += *n_want;
}

// Before K2: the scratch zeroed, then pass A: overflow_active, the runs of
// the NA sorted lanes, the run ids and first lanes, U in scratch[0].
// ``scratch`` holds ``words`` ints, at least b3_scratch_words(NA).
extern "C" int launch_integrate_lanes_cells(
        const void* sid, long M, long NA, int extra_dropped,
        void* overflow_active, void* lane_run, void* uids, void* ustart,
        void* scratch, long words, void* stream) {
    if (words < b3_scratch_words(NA)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    int* sc = (int*)scratch;
    const cudaError_t e =
        cudaMemsetAsync(sc, 0, b3_scratch_words(NA) * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    run_scan((const int*)sid, M, NA, extra_dropped, (int*)overflow_active,
             (int*)lane_run, (int*)uids, (int*)ustart, sc, sc + 2, st);
    return (int)cudaGetLastError();
}

// After K2 (uslot): pass B (the sorted points and slots for K3, the
// per-cell sums, viewpoint and bitmap, the buffer append) and the finish.
extern "C" int launch_integrate_lanes_append(
        long NA, long M, int N, const void* lane_run, const void* uids,
        const void* ustart, const void* uslot, const void* order,
        const void* world, const void* rgb, const void* poses,
        int store_color, void* n_pts, const void* normal_found,
        void* rgb_sum, void* viewpoint, void* occ_bits, void* pts,
        void* slot_pt, void* buf_pts, void* buf_slot, void* buf_count,
        long B, void* overflow_buf, void* scratch, void* stream) {
    if (NA == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    int* sc = (int*)scratch;
    const int tiles = grid_blocks(NA, B3_TILE);
    Grid3 g{(float*)n_pts, (const unsigned char*)normal_found,
            (float*)rgb_sum, (float*)viewpoint, (unsigned*)occ_bits};
    b3_lanes_kernel<<<tiles, SCAN_THREADS, 0, st>>>(
        NA, M, N, tiles, (const int*)lane_run, (const int*)uids,
        (const int*)ustart, (const int*)uslot, (const long*)order,
        (const float*)world, (const float*)rgb, (const float*)poses,
        store_color, g, (float*)pts, (int*)slot_pt, (float*)buf_pts,
        (int*)buf_slot, (const int*)buf_count, B, sc + 1,
        sc + 2 + lookback_words(NA, RUN_SCAN_TILE));
    b3_finish_kernel<<<1, 1, 0, st>>>(sc + 1, NA, B, (int*)buf_count,
                                      (int*)overflow_buf);
    return (int)cudaGetLastError();
}
