// Kernel B7: the refine's retroactive buffer replay.
//
// Replaces: refine_pass_impl in hifi_fusion_tpu/ops/refine.py :341-540:
// every dependant link written in this pass (line slot s -> owner, one of
// the pass's candidates) streams the buffered points of cell s through
// the owner's new cylinder, and the hits add [t, t^2, d, d^2, 1] into the
// owner's cyl_stats.  There the links are sorted by owner and expanded
// into a static pair-point lane space filled by segment scans, with
// budgets and tiers; the port's plain version (ops/refine.py
// buffer_replay_plain) expands them with repeat_interleave, whose length
// the host must read.  Here nothing is expanded and nothing read back.
//
// Input: the links of B6, one a sorted lane (ls: line slot, -1 where no
// link was written; lu: the candidate), the candidates' slots and fitted
// normals, and the live buffer sorted by slot (the library sort of
// buf_slot[:bc] stays, as the JAX package sorts it).
//
// Bound on the card: memory.  The links (8 B a lane), each written link's
// owner key and normal, each buffered point of a replayed cell once
// (12 B), each owner's 5 sums read and written: 75 MB at the bench's
// first refine; the f32 operations (~20 a link and point) bound it no
// higher (bounds.buffer_replay, chip_smoke.py phase 3).
//
// Design: a thread a link lane; a lane with no link returns at once.  The
// thread finds its cell's run in the sorted buffer by one binary search
// (the buffer's slots, 4 B each, stay in L2), reads the owner's key (its
// center, fma(res, c + 0.5, origin) with the shard's offset) and normal,
// and walks the run to its end, testing each point with common.cuh's
// cylinder_hit, the gate K3 and the plain version use, so a hit is
// decided bit for bit as there.  The five sums are kept in registers and
// added into the owner's row with one atomic a channel, only when the run
// had a hit.  A run holds ~5 points on average at the bench's first
// refine, so a thread a link keeps ~10^6 links in flight where a warp a
// link would leave most lanes of each warp idle.  The hit
// channel is an integer below 2^24 and therefore exact; the other four
// differ from the plain version only in addition order, held to
// checks.cyl_stats_error's rtol 1e-5 of the terms' magnitude as K3 is.

#include "common.cuh"

constexpr int B7_THREADS = 256;

// the first index in sorted a[0, n) with a[i] >= v
__device__ __forceinline__ int first_at_least(const int* a, int n, int v) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a[mid] < v) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

__global__ void __launch_bounds__(B7_THREADS)
buffer_replay_kernel(const int* __restrict__ ls, const int* __restrict__ lu,
                     long P, const int* __restrict__ cand, int U,
                     const float* __restrict__ nvec,
                     const int* __restrict__ key,
                     const int* __restrict__ bslot,
                     const float* __restrict__ bpts, int bc, Geo g,
                     float radius, float* __restrict__ cyl_stats) {
    const long k = (long)blockIdx.x * B7_THREADS + threadIdx.x;
    if (k >= P) return;
    const int s = ls[k];
    if (s < 0) return;
    int i = first_at_least(bslot, bc, s);
    if (i >= bc || bslot[i] != s) return;
    const int u = lu[k];
    const int o = cand[u];
    float c[3], nv[3];
    center_of_id(g, key[o], c);
    for (int a = 0; a < 3; ++a) nv[a] = nvec[(long)a * U + u];
    float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (; i < bc && bslot[i] == s; ++i) {
        const float p[3] = {bpts[i], bpts[(long)bc + i], bpts[2L * bc + i]};
        float t, d;
        if (cylinder_hit(p, c, nv, radius, t, d)) {
            acc[0] = __fadd_rn(acc[0], t);
            acc[1] = __fadd_rn(acc[1], __fmul_rn(t, t));
            acc[2] = __fadd_rn(acc[2], d);
            acc[3] = __fadd_rn(acc[3], __fmul_rn(d, d));
            acc[4] = __fadd_rn(acc[4], 1.0f);
        }
    }
    if (acc[4] > 0.0f) {
        float* cs = cyl_stats + 5L * o;
        for (int a = 0; a < 5; ++a) atomicAdd(cs + a, acc[a]);
    }
}

extern "C" int launch_buffer_replay(const void* ls, const void* lu, long P,
                                    const void* cand, int U,
                                    const void* nvec, const void* key,
                                    const void* bslot, const void* bpts,
                                    int bc, const float* geo_f,
                                    const int* geo_i, float radius,
                                    void* cyl_stats, void* stream) {
    if (P == 0 || bc == 0) return 0;
    buffer_replay_kernel<<<grid_blocks(P, B7_THREADS), B7_THREADS, 0,
                           (cudaStream_t)stream>>>(
        (const int*)ls, (const int*)lu, P, (const int*)cand, U,
        (const float*)nvec, (const int*)key, (const int*)bslot,
        (const float*)bpts, bc, make_geo(geo_f, geo_i), radius,
        (float*)cyl_stats);
    return (int)cudaGetLastError();
}
