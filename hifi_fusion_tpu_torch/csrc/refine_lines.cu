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
// L*U lanes (L = 2k+1, U the pass's candidates) and nothing is read back.
//
// Bound on the card: memory, and little of it.  Each candidate's slot,
// key, normal and gate are read (~21 B), each line cell's key probe and
// dep_count read and written, each written link's dep word written, and
// each lane's link (slot, candidate) written for the replay B7: 24 MB at
// the bench's first refine (bounds.refine_lines, chip_smoke.py phase 3).
// One library sort of L*U i32 keys with their lane payload sits between
// the passes.
//
// Design: three passes around the sort and K2, a thread a lane.
//  1. points: lane l = j*U + u (step-major, the JAX package's (L, U)
//     flattening) computes center + (s*res0)*n for step s = j - k, as
//     XLA's jitted program does: s*res0 rounded, then one fused
//     multiply-add onto the center (the center itself fma(res, c + 0.5,
//     origin) from the candidate's key, common.cuh), the bbox test, the
//     floor by the folded reciprocal and the coordinate window, and its
//     cell id, INVALID_ID where the lane is not valid or not gated.  The
//     line cells' floors follow from these roundings, so they must be
//     the plain version's bit for bit.  Then a stable sort by id with the
//     lane as payload: the lanes of one cell together, in (step,
//     candidate) order.
//  2. starts: the first lane of every run of equal ids keeps the id, every
//     other lane INVALID_ID; K2 takes that array whole (its sentinel lanes
//     get slot -1, uncounted).
//  3. append: the first lane of a run takes the run's slot from K2, reads
//     the cell's dep_count once, walks its run writing owner cand[u] at
//     dep_count + rank while that is under D, counts the rest into
//     overflow_dep (one atomic a run that overflowed) and stores the new
//     dep_count; every lane gets its link (line slot, -1 where none was
//     written) and candidate for B7.  A cell that found no slot links
//     nothing and counts nothing, as the JAX package drops its lanes.
// The JAX package (and the plain version) scatters the slots back to the
// lanes and sorts the links again, by slot.  One cell has one slot, so
// grouping by slot groups the same lanes as grouping by cell id, and both
// stable sorts leave a group in (step, candidate) order: the rank of
// every link, and so which owners win when D binds, is the same without
// the second sort.  Only the order of the groups differs, which nothing
// reads (B7 adds each link's hits with atomics).  A run is as long as the
// number of lines visiting one cell, a few lanes on average, so a thread
// walking it is cheap; a parallel rank is later work.

#include "common.cuh"

constexpr int B6_THREADS = 256;

__global__ void __launch_bounds__(B6_THREADS)
b6_points_kernel(const int* __restrict__ cand, int U, int L, int line_k,
                 float res0, const int* __restrict__ key,
                 const float* __restrict__ nvec,
                 const unsigned char* __restrict__ gated, Geo g,
                 int* __restrict__ lid) {
    const long l = (long)blockIdx.x * B6_THREADS + threadIdx.x;
    if (l >= (long)L * U) return;
    const int j = (int)(l / U), u = (int)(l % U);
    int id = INVALID_ID;
    if (gated[u]) {
        float c[3], p[3];
        center_of_id(g, key[cand[u]], c);
        const float sr = __fmul_rn((float)(j - line_k), res0);
        for (int a = 0; a < 3; ++a)
            p[a] = __fmaf_rn(sr, nvec[(long)a * U + u], c[a]);
        int cc[3];
        if (cell_coords_valid(g, p, cc, true))
            id = (cc[0] * g.dims[1] + cc[1]) * g.dims[2] + cc[2];
    }
    lid[l] = id;
}

__global__ void __launch_bounds__(B6_THREADS)
b6_starts_kernel(const int* __restrict__ sid, long P,
                 int* __restrict__ start_ids) {
    const long i = (long)blockIdx.x * B6_THREADS + threadIdx.x;
    if (i >= P) return;
    const int v = sid[i];
    start_ids[i] = v != INVALID_ID && (i == 0 || sid[i - 1] != v)
                   ? v : INVALID_ID;
}

__global__ void __launch_bounds__(B6_THREADS)
b6_append_kernel(const int* __restrict__ sid, const long* __restrict__ lane,
                 const int* __restrict__ start_ids,
                 const int* __restrict__ kslot, long P, int U,
                 const int* __restrict__ cand, int D, int* __restrict__ dep,
                 int* __restrict__ dep_count, int* __restrict__ overflow_dep,
                 int* __restrict__ ls, int* __restrict__ lu) {
    const long i = (long)blockIdx.x * B6_THREADS + threadIdx.x;
    if (i >= P) return;
    const int v = sid[i];
    if (v == INVALID_ID) {
        ls[i] = -1;
        lu[i] = (int)(lane[i] % U);
        return;
    }
    if (start_ids[i] == INVALID_ID) return;     // not a run's first lane
    const int s = kslot[i];
    const int base = s >= 0 ? dep_count[s] : 0;
    int written = 0, over = 0;
    for (long x = i; x < P && sid[x] == v; ++x) {
        const int u = (int)(lane[x] % U);
        const int pos = base + (int)(x - i);
        lu[x] = u;
        if (s >= 0 && pos < D) {
            dep[(long)s * D + pos] = cand[u];
            ls[x] = s;
            ++written;
        } else {
            ls[x] = -1;
            over += s >= 0;
        }
    }
    if (s >= 0) dep_count[s] = base + written;
    if (over) atomicAdd(overflow_dep, over);
}

// Pass 1: the (L*U,) line-cell ids, INVALID_ID where none.
extern "C" int launch_refine_lines_points(
        const void* cand, int U, int L, int line_k, float res0,
        const void* key, const void* nvec, const void* gated,
        const float* geo_f, const int* geo_i, void* lid, void* stream) {
    const long P = (long)L * U;
    if (P == 0) return 0;
    b6_points_kernel<<<grid_blocks(P, B6_THREADS), B6_THREADS, 0,
                       (cudaStream_t)stream>>>(
        (const int*)cand, U, L, line_k, res0, (const int*)key,
        (const float*)nvec, (const unsigned char*)gated,
        make_geo(geo_f, geo_i), (int*)lid);
    return (int)cudaGetLastError();
}

// Pass 2: the run-start ids of the sorted line-cell ids, for K2.
extern "C" int launch_refine_lines_starts(const void* sid, long P,
                                          void* start_ids, void* stream) {
    if (P == 0) return 0;
    b6_starts_kernel<<<grid_blocks(P, B6_THREADS), B6_THREADS, 0,
                       (cudaStream_t)stream>>>(
        (const int*)sid, P, (int*)start_ids);
    return (int)cudaGetLastError();
}

// Pass 3: the dependant append and the links for the replay.
extern "C" int launch_refine_lines_append(
        const void* sid, const void* lane, const void* start_ids,
        const void* kslot, long P, int U, const void* cand, int D, void* dep,
        void* dep_count, void* overflow_dep, void* ls, void* lu,
        void* stream) {
    if (P == 0) return 0;
    b6_append_kernel<<<grid_blocks(P, B6_THREADS), B6_THREADS, 0,
                       (cudaStream_t)stream>>>(
        (const int*)sid, (const long*)lane, (const int*)start_ids,
        (const int*)kslot, P, U, (const int*)cand, D, (int*)dep,
        (int*)dep_count, (int*)overflow_dep, (int*)ls, (int*)lu);
    return (int)cudaGetLastError();
}
