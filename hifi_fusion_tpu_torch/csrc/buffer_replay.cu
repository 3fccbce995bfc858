// Kernel B7: the refine's retroactive buffer replay.
//
// Replaces: refine_pass_impl in hifi_fusion_tpu/ops/refine.py :341-540:
// every dependant link written in this pass (line slot s -> owner, one of
// the pass's candidates) streams the buffered points of cell s through
// the owner's new cylinder, and the hits add [t, t^2, d, d^2, 1] into the
// owner's cyl_stats.  There the links are sorted by owner and expanded
// into a static pair-point lane space filled by segment scans, with
// budgets and tiers, each owner's segment summed and scattered once.
//
// Input: B6's links owner-major, a (U, L) i32 array: row u holds, for
// each line step of candidate u, the line slot where its link was written
// (-1 where none was: not valid, not gated, D full); the candidates'
// slots and fitted normals; and the live buffer sorted by slot (the
// library sort of buf_slot[:bc] stays, as the JAX package sorts it), its
// points in (3, bc) planes.
//
// Bound on the card: memory.  The links (4 B a lane), each linked
// candidate's slot, key and normal once, each buffered point of a
// replayed cell once with its slot, each owner's 5 sums read and written:
// 52.5 MB at the bench's first refine; the f32 operations (~20 a link and
// point) bound it no higher (bounds.buffer_replay, chip_smoke.py phase
// 3).
//
// Design: two launches, no atomics, no search of the buffer.
//  1. runs, a thread a buffer lane: table[s] = (i, e), the first lane
//     and one past the last of each slot's run, written by the run's
//     first and last lanes.  The (C, 2) table is never cleared: a lookup
//     of slot s accepts (i, e) only when 0 <= i < e <= bc, bslot[i] ==
//     bslot[e - 1] == s, i is a run's first lane (i == 0 or bslot[i - 1]
//     != s) and e - 1 its last (e == bc or bslot[e] != s), which no stale
//     entry of an earlier pass and no garbage can pass; a slot with no
//     buffered point has no such lanes;
//  2. replay, a group of G lanes a candidate, G the power of two >= L
//     (8 at line_k = 3), at most 32, chosen by ops/refine.py
//     replay_group.  Lane j looks up step j's run (steps
//     j, j + G, ... in rounds when L > G) and the group scans the runs'
//     lengths: the candidate's (link, point) pairs, its runs end to end
//     in step order, are numbered p = 0, 1, ... and lane p % G takes
//     pair p, finding its run by a binary search over the runs' first
//     pair numbers (shuffles).  So a group's loads are independent of one
//     another and of the buffer's slots, neighbouring lanes read
//     neighbouring points, a run of hundreds of points is shared by the
//     group and a step without a run costs nothing: ceil(pairs / G) loads
//     a lane.  Each point is tested with common.cuh's cylinder_hit, the
//     gate K3 and the plain version use, so a hit is decided bit for bit
//     as there.  Each lane sums its hits in the order of p; the group
//     adds its lanes' sums in a fixed xor-shuffle tree (pairs of
//     neighbouring lanes, then pairs of pairs); lane 0 adds the five
//     totals to the owner's row with one plain load and store, when the
//     owner had a hit.  Each candidate is one owner and no other thread
//     writes its row in the launch, so cyl_stats is bit-identical from
//     run to run, and equal to the plain version (ops/refine.py
//     buffer_replay_plain), which sums in the same order.
// What holds it near 7x its bound is traffic the bound does not count:
// each link's table entry and slot checks are random 32-byte sectors,
// and a point is read once for every owner whose line visits its cell.

#include "common.cuh"

constexpr int B7_THREADS = 256;

__global__ void __launch_bounds__(B7_THREADS)
b7_runs_kernel(const int* __restrict__ bslot, int bc, int C,
               int* __restrict__ table) {
    const int i = blockIdx.x * B7_THREADS + threadIdx.x;
    if (i >= bc) return;
    const int s = bslot[i];
    if ((unsigned)s >= (unsigned)C) return;
    if (i == 0 || bslot[i - 1] != s) table[2L * s] = i;
    if (i == bc - 1 || bslot[i + 1] != s) table[2L * s + 1] = i + 1;
}

// slot s's run [i, e) in the slot-sorted buffer: its first lane, and its
// length (0 where s has no buffered point).  The four slot reads are
// issued together, at indices clamped into the buffer.
__device__ __forceinline__ int run_of(const int2* __restrict__ table,
                                      const int* __restrict__ bslot, int bc,
                                      int s, int& n) {
    const int2 r = table[s];
    const bool in = r.x >= 0 && r.x < r.y && r.y <= bc;
    const int i = in ? r.x : 0, e = in ? r.y : 1;
    const int first = bslot[i], last = bslot[e - 1];
    const int before = bslot[i > 0 ? i - 1 : 0];
    const int after = bslot[e < bc ? e : bc - 1];
    const bool ok = in & (first == s) & (last == s)
                    & ((i == 0) | (before != s)) & ((e == bc) | (after != s));
    n = ok ? e - i : 0;
    return i;
}

// one (link, point) pair: point i through the owner's cylinder (center
// c, normal nv), a hit's [t, t^2, d, d^2, 1] added to the lane's sums
__device__ __forceinline__ void add_pair(const float* __restrict__ bpts,
                                         int bc, int i, const float* c,
                                         const float* nv, float radius,
                                         float* acc) {
    const float q[3] = {bpts[i], bpts[(long)bc + i], bpts[2L * bc + i]};
    float t, d;
    if (cylinder_hit(q, c, nv, radius, t, d)) {
        acc[0] = __fadd_rn(acc[0], t);
        acc[1] = __fadd_rn(acc[1], __fmul_rn(t, t));
        acc[2] = __fadd_rn(acc[2], d);
        acc[3] = __fadd_rn(acc[3], __fmul_rn(d, d));
        acc[4] = __fadd_rn(acc[4], 1.0f);
    }
}

__global__ void __launch_bounds__(B7_THREADS)
b7_replay_kernel(const int* __restrict__ links, int U, int L, int G,
                 const int* __restrict__ cand,
                 const float* __restrict__ nvec,
                 const int* __restrict__ key,
                 const int* __restrict__ bslot,
                 const float* __restrict__ bpts, int bc,
                 const int2* __restrict__ table, Geo g, float radius,
                 float* __restrict__ cyl_stats) {
    const int u = (blockIdx.x * B7_THREADS + threadIdx.x) / G;
    if (u >= U) return;              // whole groups: G divides the warp
    const int j = threadIdx.x & (G - 1);
    const int gbase = (threadIdx.x & 31) - j;
    const unsigned gmask =
        G == 32 ? 0xffffffffu : ((1u << G) - 1u) << gbase;
    float c[3], nv[3];
    center_of_id(g, key[cand[u]], c);
    for (int a = 0; a < 3; ++a) nv[a] = nvec[(long)a * U + u];
    float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    const int* row = links + (long)u * L;
    int p0 = 0;                              // pairs of the earlier rounds
    for (int s0 = 0; s0 < L; s0 += G) {
        int n = 0, start = 0;
        const int s = s0 + j < L ? row[s0 + j] : -1;
        if (s >= 0) start = run_of(table, bslot, bc, s, n);
        int off = n;                         // inclusive, then exclusive
        for (int d = 1; d < G; d <<= 1) {
            const int v = __shfl_up_sync(gmask, off, d, G);
            if (j >= d) off += v;
        }
        const int T = __shfl_sync(gmask, off, G - 1, G);
        off -= n;
        // lane j takes the pairs p of this round with (p0 + p) % G == j
        for (int base = 0; base < T; base += G) {
            const int p = base + ((j - p0) & (G - 1));
            int k = 0;                       // the last run at or before p
            for (int h = G >> 1; h > 0; h >>= 1)
                if (__shfl_sync(gmask, off, k + h, G) <= p) k += h;
            const int i = __shfl_sync(gmask, start, k, G) + p
                          - __shfl_sync(gmask, off, k, G);
            if (p < T) add_pair(bpts, bc, i, c, nv, radius, acc);
        }
        p0 += T;
    }
    for (int h = 1; h < G; h <<= 1)
        for (int a = 0; a < 5; ++a)
            acc[a] = __fadd_rn(acc[a], __shfl_xor_sync(gmask, acc[a], h));
    if (j == 0 && acc[4] > 0.0f) {
        float* cs = cyl_stats + 5L * cand[u];
        for (int a = 0; a < 5; ++a) cs[a] = __fadd_rn(cs[a], acc[a]);
    }
}

// The runs table ((C, 2) ints, any contents) and the replay.  U
// candidates with L line steps each, G lanes a candidate (a power of two,
// at most 32: ops/refine.py replay_group).
extern "C" int launch_buffer_replay(const void* links, int U, int L, int G,
                                    const void* cand, const void* nvec,
                                    const void* key, const void* bslot,
                                    const void* bpts, int bc, void* table,
                                    int C, const float* geo_f,
                                    const int* geo_i, float radius,
                                    void* cyl_stats, void* stream) {
    if (U == 0 || L == 0 || bc == 0) return 0;
    if (G < 1 || G > 32 || (G & (G - 1))) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    b7_runs_kernel<<<grid_blocks(bc, B7_THREADS), B7_THREADS, 0, st>>>(
        (const int*)bslot, bc, C, (int*)table);
    b7_replay_kernel<<<grid_blocks((long)U * G, B7_THREADS), B7_THREADS, 0,
                       st>>>(
        (const int*)links, U, L, G, (const int*)cand, (const float*)nvec,
        (const int*)key, (const int*)bslot, (const float*)bpts, bc,
        (const int2*)table, make_geo(geo_f, geo_i), radius,
        (float*)cyl_stats);
    return (int)cudaGetLastError();
}
