// Kernel B6: the refine's line cells and the dependant append.
//
// Replaces: refine_pass_impl in hifi_fusion_tpu/ops/refine.py :262-339:
// the 2k+1 line points along each gated candidate's new normal, their
// cell ids, the line cells found or inserted (a new one is a ghost: a
// key, no points), and each candidate appended as an owner to the
// dependant list of every cell its line visits, at dep_count + rank while
// that is under D, else counted in overflow_dep.  There it is two payload
// sorts, segment scans and unique-index scatters; the port's plain version
// (ops/refine.py refine_lines_plain) is eager ops with torch.unique and
// boolean masks, whose shapes the host must read.  Here every array is
// P = L*U lanes (L = 2k+1, U the pass's candidates) and nothing is read
// back.
//
// Bound on the card: memory, and little of it.  Each candidate's slot,
// key, normal and gate are read (~21 B), each line cell's key probe and
// dep_count read and written, each written link's dep word written, and
// each lane's link (its slot or -1) written for the replay B7: 20 MB at
// the bench's first refine (bounds.refine_lines, chip_smoke.py phase 3),
// which counts the hand passes; the one library sort of P i32 keys with
// their lane payload between them is timed apart.  Most of the hand
// passes' time is the dependant writes, 4 bytes each into scattered
// 40-byte rows, and the cells' dep_count and key probes.
//
// Design: around the sort and K2, four launches and a memset, every index
// in 32 bits (the wrapper refuses P >= 2^31):
//  1. points, a thread a lane: lane l = j*U + u (step-major, the JAX
//     package's (L, U) flattening) computes center + (s*res0)*n for step
//     s = j - k, as XLA's jitted program does: s*res0 rounded, then one
//     fused multiply-add onto the center (the center itself fma(res, c +
//     0.5, origin) from the candidate's key, common.cuh), the bbox test,
//     the floor by the folded reciprocal and the coordinate window, and
//     its cell id, INVALID_ID where the lane is not valid or not gated.
//     The line cells' floors follow from these roundings, so they must be
//     the plain version's bit for bit.  Then a stable sort by id with the
//     lane as payload: the lanes of one cell together, in (step,
//     candidate) order;
//  2. cells: the scratch zeroed, then scan.cuh's run scan over the sorted
//     lanes (decoupled look-back): each valid lane's run, the compacted
//     line-cell ids (uids), each run's first lane (ustart) and U on the
//     card; K2 takes the ids with U as its live count;
//  3. runs, a thread a run: base = dep_count[s], dep_count[s] = base +
//     min(len, max(D - base, 0)); the run's unwritten lanes go into
//     overflow_dep with one atomic a block; a run whose cell found no
//     slot (s < 0) links nothing and counts nothing, as the JAX package
//     drops its lanes;
//  4. lanes, a thread a lane: pos = base + (i - ustart[u]); the owner
//     cand[u] (u = lane % U, step j = lane / U) is written at dep[s*D +
//     pos] while pos < D, and the lane's link for B7 at links[u*L + j],
//     owner-major: the line slot, -1 where none was written.
// The JAX package (and the plain version) scatters the slots back to the
// lanes and sorts the links again, by slot.  One cell has one slot, so
// grouping by slot groups the same lanes as grouping by cell id, and both
// stable sorts leave a group in (step, candidate) order: the rank of
// every link, and so which owners win when D binds, is the same without
// the second sort.  Only the order of the groups differs, which nothing
// reads: B7 takes the links by owner, as the JAX package sorts them for
// its replay.

#include "scan.cuh"

constexpr int B6_THREADS = 256;

// the scratch's ints: [U, unused (alignment), the run scan's look-back]
static inline long b6_scratch_words(long P) {
    return 2 + lookback_words(P, RUN_SCAN_TILE);
}

__global__ void __launch_bounds__(B6_THREADS)
b6_points_kernel(const int* __restrict__ cand, unsigned U, unsigned P,
                 int line_k, float res0, const int* __restrict__ key,
                 const float* __restrict__ nvec,
                 const unsigned char* __restrict__ gated, Geo g,
                 int* __restrict__ lid) {
    const unsigned l = blockIdx.x * B6_THREADS + threadIdx.x;
    if (l >= P) return;
    const unsigned j = l / U, u = l - j * U;
    int id = INVALID_ID;
    if (gated[u]) {
        float c[3], p[3];
        center_of_id(g, key[cand[u]], c);
        const float sr = __fmul_rn((float)((int)j - line_k), res0);
        for (int a = 0; a < 3; ++a)
            p[a] = __fmaf_rn(sr, nvec[a * U + u], c[a]);
        int cc[3];
        if (cell_coords_valid(g, p, cc, true))
            id = (cc[0] * g.dims[1] + cc[1]) * g.dims[2] + cc[2];
    }
    lid[l] = id;
}

__global__ void __launch_bounds__(B6_THREADS)
b6_runs_kernel(const int* __restrict__ n_runs,
               const int* __restrict__ ustart,
               const int* __restrict__ kslot, int D,
               int* __restrict__ dep_count, int* __restrict__ overflow_dep,
               int* __restrict__ rebase) {
    __shared__ int warp_over[B6_THREADS / 32];
    const int nr = *n_runs;
    if (blockIdx.x * B6_THREADS >= nr) return;      // the whole block past U
    const int u = blockIdx.x * B6_THREADS + threadIdx.x;
    int over = 0;
    const int s = u < nr ? kslot[u] : -1;
    if (s >= 0) {
        const int lo = ustart[u], len = ustart[u + 1] - lo;
        const int base = dep_count[s];
        const int w = min(len, max(D - base, 0));
        dep_count[s] = base + w;
        rebase[u] = base - lo;
        over = len - w;
    }
    for (int d = 16; d > 0; d >>= 1)
        over += __shfl_down_sync(FULL_MASK, over, d);
    if ((threadIdx.x & 31) == 0) warp_over[threadIdx.x >> 5] = over;
    __syncthreads();
    if (threadIdx.x == 0) {
        int total = 0;
        for (int w = 0; w < B6_THREADS / 32; ++w) total += warp_over[w];
        if (total != 0) atomicAdd(overflow_dep, total);
    }
}

__global__ void __launch_bounds__(B6_THREADS)
b6_lanes_kernel(const long* __restrict__ lane,
                const int* __restrict__ lane_run,
                const int* __restrict__ kslot,
                const int* __restrict__ rebase, unsigned P, unsigned U,
                unsigned L, const int* __restrict__ cand, int D,
                int* __restrict__ dep, int* __restrict__ links) {
    const unsigned i = blockIdx.x * B6_THREADS + threadIdx.x;
    if (i >= P) return;
    const unsigned l = (unsigned)lane[i], j = l / U, uc = l - j * U;
    const int r = lane_run[i];
    int out = -1;
    if (r >= 0) {
        const int s = kslot[r];
        if (s >= 0) {
            const int pos = rebase[r] + (int)i;
            if (pos < D) {
                dep[(long)s * D + pos] = cand[uc];
                out = s;
            }
        }
    }
    links[uc * L + j] = out;
}

// Pass 1: the (L*U,) line-cell ids, INVALID_ID where none.
extern "C" int launch_refine_lines_points(
        const void* cand, int U, int L, int line_k, float res0,
        const void* key, const void* nvec, const void* gated,
        const float* geo_f, const int* geo_i, void* lid, void* stream) {
    const long P = (long)L * U;
    if (P == 0) return 0;
    if (P >= (1L << 31)) return (int)cudaErrorInvalidValue;
    b6_points_kernel<<<grid_blocks(P, B6_THREADS), B6_THREADS, 0,
                       (cudaStream_t)stream>>>(
        (const int*)cand, (unsigned)U, (unsigned)P, line_k, res0,
        (const int*)key, (const float*)nvec, (const unsigned char*)gated,
        make_geo(geo_f, geo_i), (int*)lid);
    return (int)cudaGetLastError();
}

// Pass 2: the runs of the sorted line-cell ids (lane_run, uids, ustart,
// U in scratch[0]), for K2.  ``scratch`` holds ``words`` ints, at least
// b6_scratch_words(P).
extern "C" int launch_refine_lines_cells(const void* sid, long P,
                                         void* lane_run, void* uids,
                                         void* ustart, void* scratch,
                                         long words, void* stream) {
    if (P == 0) return 0;
    if (P >= (1L << 31) || words < b6_scratch_words(P))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    int* sc = (int*)scratch;
    const cudaError_t e =
        cudaMemsetAsync(sc, 0, b6_scratch_words(P) * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    run_scan((const int*)sid, P, P, 0, nullptr, (int*)lane_run,
             (int*)uids, (int*)ustart, sc, sc + 2, st);
    return (int)cudaGetLastError();
}

// Passes 3-4: the dependant append and the (U, L) links for the replay.
// ``rebase`` holds P ints of scratch (a run's base - ustart).
extern "C" int launch_refine_lines_append(
        const void* lane, const void* lane_run, const void* ustart,
        const void* kslot, const void* n_runs, long P, int U, int L,
        const void* cand, int D, void* dep, void* dep_count,
        void* overflow_dep, void* rebase, void* links, void* stream) {
    if (P == 0) return 0;
    if (P >= (1L << 31)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    b6_runs_kernel<<<grid_blocks(P, B6_THREADS), B6_THREADS, 0, st>>>(
        (const int*)n_runs, (const int*)ustart, (const int*)kslot, D,
        (int*)dep_count, (int*)overflow_dep, (int*)rebase);
    b6_lanes_kernel<<<grid_blocks(P, B6_THREADS), B6_THREADS, 0, st>>>(
        (const long*)lane, (const int*)lane_run, (const int*)kslot,
        (const int*)rebase, (unsigned)P, (unsigned)U, (unsigned)L,
        (const int*)cand, D, (int*)dep, (int*)links);
    return (int)cudaGetLastError();
}
