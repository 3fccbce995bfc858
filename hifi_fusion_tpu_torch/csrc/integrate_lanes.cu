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
// third K=8 batch (bounds.integrate_lanes, chip_smoke.py phase 3).
//
// Design: simple and right first, eight launches around K2 and no host
// read.  Before K2 (launch_integrate_lanes_cells):
//  1. meta: one thread finds n_act, the first INVALID lane of the whole
//     sorted batch, by binary search, and adds max(n_act - NA, 0) plus
//     the router's drops into overflow_active;
//  2-4. a device-wide scan (scan.cuh) of the run-start flags over the NA
//     lanes: every valid lane gets its run u, each run start writes the
//     run's id and first lane (uids[u], ustart[u]), the last valid lane
//     writes ustart[U] = n_sv, and U is left in scratch[0].
// Then K2 finds or inserts the run ids (hashing.lookup_or_insert), given
// the NA-lane array and the device's U as its live count, so it touches
// only the U ids.  After it (launch_integrate_lanes_append):
//  5. runs: a thread per run (the threads past the device's U return);
//     the cell's slot is its own (the ids are distinct), so Σrgb and the
//     count are added into rgb_sum and n_pts without atomics, and they are
//     exact in any order (integer-valued f32); the viewpoint of the run's
//     first lane (its earliest frame) is stamped where the cell held no
//     point; the cell's bitmap bit is set with atomicOr, exact for
//     distinct ids; a run whose cell was placed and has no normal yet
//     wants its lanes appended, want_len[u] = its length;
//  6-8. a device-wide scan of want_len over the runs gives each run its
//     offset among the wanted lanes, in sorted-lane order (the plain
//     version's pts[:, want] order), and then a thread per lane writes
//     the sorted point and slot that K3 streams (slot -1 past n_sv and for
//     an unplaced cell) and, when buf_count + NA <= B (all or nothing),
//     its wanted point at buf_count + rank;
//  9. finish: one thread adds the wanted total to buf_count, or to
//     overflow_buf when the batch did not fit.
// The slots K2 hands out may differ from the plain version's (the CAS race
// against its first-in-input-order election); everything else is equal,
// compared by cell id.

#include "scan.cuh"

constexpr int B3_THREADS = 256;

// the first lane of sorted ids[0, m) holding INVALID_ID, else m
__device__ __forceinline__ long first_invalid(const int* ids, long m) {
    long lo = 0, hi = m;
    while (lo < hi) {
        const long mid = (lo + hi) >> 1;
        if (ids[mid] == INVALID_ID) hi = mid;
        else lo = mid + 1;
    }
    return lo;
}

__global__ void b3_meta_kernel(const int* __restrict__ sid, long M, long NA,
                               int extra_dropped,
                               int* __restrict__ overflow_active) {
    const long n_act = first_invalid(sid, M);
    const long over = n_act > NA ? n_act - NA : 0;
    if (over + extra_dropped != 0)
        *overflow_active += (int)over + extra_dropped;
}

// the run-start scan over the NA sorted lanes
struct RunStarts {
    const int* sid;
    long NA;
    int* lane_run;     // (NA,) run of the lane, -1 past n_sv
    int* uids;         // (NA,) run id, unset past U
    int* ustart;       // (NA+1,) first lane of run u; ustart[U] = n_sv
    __device__ bool valid(long i) const { return sid[i] != INVALID_ID; }
    __device__ int count(long i) const {
        return valid(i) && (i == 0 || sid[i - 1] != sid[i]);
    }
    __device__ void apply(long i, int prefix, int total) const {
        const int start = count(i);
        if (valid(i)) {
            const int u = prefix + start - 1;
            lane_run[i] = u;
            if (start) {
                uids[u] = sid[i];
                ustart[u] = (int)i;
            }
            if (i + 1 == NA || !valid(i + 1)) ustart[total] = (int)(i + 1);
        } else {
            lane_run[i] = -1;
        }
    }
};

struct Grid3 {
    float* n_pts;
    const unsigned char* normal_found;
    float* rgb_sum;
    float* viewpoint;
    unsigned* occ_bits;
};

__global__ void __launch_bounds__(B3_THREADS)
b3_runs_kernel(const int* __restrict__ U_dev, long NA,
               const int* __restrict__ uids, const int* __restrict__ ustart,
               const int* __restrict__ uslot,
               const long* __restrict__ order, const float* __restrict__ rgb,
               long M, int N, const float* __restrict__ poses,
               int store_color, Grid3 g, int* __restrict__ want_len) {
    const long u = (long)blockIdx.x * B3_THREADS + threadIdx.x;
    if (u >= NA || u >= *U_dev) return;
    const int s = uslot[u];
    const int lo = ustart[u], hi = ustart[u + 1];
    int want = 0;
    if (s >= 0) {
        const bool occ0 = g.n_pts[s] > 0.0f;
        const bool nf0 = g.normal_found[s] != 0;
        if (store_color) {
            float acc[3] = {0.f, 0.f, 0.f};
            for (int k = lo; k < hi; ++k) {
                const long o = order[k];
                for (int a = 0; a < 3; ++a)
                    acc[a] = __fadd_rn(acc[a], rgb[(long)a * M + o]);
            }
            for (int a = 0; a < 3; ++a)
                g.rgb_sum[3L * s + a] = __fadd_rn(g.rgb_sum[3L * s + a],
                                                  acc[a]);
        }
        g.n_pts[s] = __fadd_rn(g.n_pts[s], (float)(hi - lo));
        if (!occ0) {
            const float* T = poses + 16L * (order[lo] / N);
            for (int a = 0; a < 3; ++a) g.viewpoint[3L * s + a] = T[4 * a + 3];
        }
        const int id = uids[u];
        atomicOr(g.occ_bits + (id >> 5), 1u << (id & 31));
        want = nf0 ? 0 : hi - lo;
    }
    want_len[u] = want;
}

// the wanted-lane scan over the runs
struct WantRuns {
    const int* U_dev;
    const int* want_len;
    int* want_off;
    __device__ int count(long u) const {
        return u < *U_dev ? want_len[u] : 0;
    }
    __device__ void apply(long u, int prefix, int) const {
        want_off[u] = prefix;
    }
};

__global__ void __launch_bounds__(B3_THREADS)
b3_lanes_kernel(long NA, const int* __restrict__ lane_run,
                const int* __restrict__ uslot, const int* __restrict__ ustart,
                const int* __restrict__ want_len,
                const int* __restrict__ want_off,
                const long* __restrict__ order,
                const float* __restrict__ world, long M,
                float* __restrict__ pts, int* __restrict__ slot_pt,
                float* __restrict__ buf_pts, int* __restrict__ buf_slot,
                const int* __restrict__ buf_count, long B) {
    const long i = (long)blockIdx.x * B3_THREADS + threadIdx.x;
    if (i >= NA) return;
    const int u = lane_run[i];
    if (u < 0) {
        slot_pt[i] = -1;
        for (int a = 0; a < 3; ++a) pts[a * NA + i] = 0.0f;
        return;
    }
    const int s = uslot[u];
    const long o = order[i];
    float p[3];
    for (int a = 0; a < 3; ++a) {
        p[a] = world[a * M + o];
        pts[a * NA + i] = p[a];
    }
    slot_pt[i] = s;
    const long bc = *buf_count;
    if (want_len[u] > 0 && bc + NA <= B) {
        const long at = bc + want_off[u] + (i - ustart[u]);
        for (int a = 0; a < 3; ++a) buf_pts[a * B + at] = p[a];
        buf_slot[at] = s;
    }
}

__global__ void b3_finish_kernel(const int* __restrict__ n_want, long NA,
                                 long B, int* __restrict__ buf_count,
                                 int* __restrict__ overflow_buf) {
    if (*buf_count + NA <= B) *buf_count += *n_want;
    else *overflow_buf += *n_want;
}

// Before K2: overflow_active, the runs of the NA sorted lanes, the run
// ids and first lanes.  scratch: ints laid out as
// [U, n_want, tiles...] (2 + scan_tiles_needed(NA)).
extern "C" int launch_integrate_lanes_cells(
        const void* sid, long M, long NA, int extra_dropped,
        void* overflow_active, void* lane_run, void* uids, void* ustart,
        void* scratch, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    b3_meta_kernel<<<1, 1, 0, st>>>((const int*)sid, M, NA, extra_dropped,
                                    (int*)overflow_active);
    if (NA > 0) {
        int* sc = (int*)scratch;
        RunStarts op{(const int*)sid, NA, (int*)lane_run, (int*)uids,
                     (int*)ustart};
        device_scan(op, NA, sc + 2, sc, st);
    }
    return (int)cudaGetLastError();
}

// After K2 (uslot): the per-cell sums, viewpoint, bitmap, the buffer
// append, and the sorted points and slots for K3.
extern "C" int launch_integrate_lanes_append(
        long NA, long M, int N, const void* lane_run, const void* uids,
        const void* ustart, const void* uslot, const void* order,
        const void* world, const void* rgb, const void* poses,
        int store_color, void* n_pts, const void* normal_found,
        void* rgb_sum, void* viewpoint, void* occ_bits, void* want_len,
        void* want_off, void* pts, void* slot_pt, void* buf_pts,
        void* buf_slot, void* buf_count, long B, void* overflow_buf,
        void* scratch, void* stream) {
    if (NA == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    int* sc = (int*)scratch;
    const int blocks = grid_blocks(NA, B3_THREADS);
    Grid3 g{(float*)n_pts, (const unsigned char*)normal_found,
            (float*)rgb_sum, (float*)viewpoint, (unsigned*)occ_bits};
    b3_runs_kernel<<<blocks, B3_THREADS, 0, st>>>(
        sc, NA, (const int*)uids, (const int*)ustart, (const int*)uslot,
        (const long*)order, (const float*)rgb, M, N, (const float*)poses,
        store_color, g, (int*)want_len);
    WantRuns op{sc, (const int*)want_len, (int*)want_off};
    device_scan(op, NA, sc + 2, sc + 1, st);
    b3_lanes_kernel<<<blocks, B3_THREADS, 0, st>>>(
        NA, (const int*)lane_run, (const int*)uslot, (const int*)ustart,
        (const int*)want_len, (const int*)want_off, (const long*)order,
        (const float*)world, M, (float*)pts, (int*)slot_pt,
        (float*)buf_pts, (int*)buf_slot, (const int*)buf_count, B);
    b3_finish_kernel<<<1, 1, 0, st>>>(sc + 1, NA, B, (int*)buf_count,
                                      (int*)overflow_buf);
    return (int)cudaGetLastError();
}
