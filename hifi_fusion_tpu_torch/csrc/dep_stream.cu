// Kernel K3: the dependant cylinder stream of an integrate batch.
//
// Replaces: the dependant streaming of integrate_frame_impl in
// hifi_fusion_tpu/ops/integrate.py (_pair_block :590-766 and
// _resid_block :512-588).  There, owner constants reach point lanes
// through an owner sort, run-start gathers, segment fills and a sort back,
// and per-owner sums through segmented scans, because random gathers are
// slow on a TPU.  On the card an owner's constants are read directly.
//
// Bound on the card: memory, and little of it.  Each point lane reads its
// position and slot (16 B); each cell reads its dep_count and owner row,
// each distinct owner its key and normal (16 B), and each owner with a hit
// reads and writes its 5 cyl_stats sums (40 B): ~50 MB at the fusion
// bench's third K=8 batch, ~0.015 ms at 3.35 TB/s (chip_smoke.py computes
// it from the batch's own counts, hifi_fusion_tpu_torch/bounds.py).  What
// holds it back is latency: a window of points reads its slots, then its
// cells' owner rows, then the owners' keys and normals, three dependent
// scattered reads.  A thread per point would also repeat its cell's owner
// reads once per point and issue 5 f32 atomics per cylinder hit (~30 M a
// batch) on the same few addresses.
//
// Design: lanes with one slot are contiguous (the caller sorts points by
// cell), so a run of equal slots is one cell's points (16.5 on average at
// the bench size).  One warp owns the runs that start in its chunk of 128
// lanes and walks them in 32-lane windows, each window starting at a run's
// first lane.  The runs that end inside a window are streamed together,
// one lane a point, each run a group of lanes: the group's first lane
// reads dep_count while its lanes read the owner row (lane j owner j, in
// rounds when the run has fewer points than owners) with each owner's key
// and normal, one fetch per (cell, owner).  For owner j of every group at
// once, the owner's center and normal go to the group's lanes by shuffle;
// each lane tests its point with the same gate as the plain version,
// center = fma(res, coord + 0.5, origin) from the owner's key, q = p - c,
// t = q.n, r = q - t*n, d = |r| in the JAX operation order with
// round-to-nearest intrinsics (common.cuh cylinder_hit, shared with the
// refine's replay B7), so d < cylinder_radius decides exactly as the
// plain version does; a segmented shuffle sum gathers [t, t^2, d, d^2]
// at the group's first lane, a ballot counts the hits, and that lane
// issues the 5 atomicAdds: one set per (cell, owner) with a hit.  The next
// window starts at the last run that did not end; a run longer than the
// window is streamed alone, 32 points at a time.  The hit channel is an
// integer below 2^24 and therefore exact; the other four sums differ from
// the plain version only in addition order.  A deterministic per-owner
// reduction is later work.

#include "common.cuh"

#define K3_CHUNK 128          // lanes whose runs one warp owns
#define K3_WARPS 4            // warps per CTA
#define FULL_MASK 0xffffffffu
#define K3_PAST_END (-2)      // the slot of a lane at or past n

// The first lane in [from, limit) whose slot is not s, else limit.
__device__ __forceinline__ int next_change(const int* __restrict__ slots,
                                           int from, int limit, int s,
                                           int wl) {
    for (int x = from; x < limit; x += 32) {
        const int i = x + wl;
        const uint32_t b =
            __ballot_sync(FULL_MASK, i < limit && slots[i] != s);
        if (b) return x + __ffs(b) - 1;
    }
    return limit;
}

// One cell's run [lo, hi) of points through its owners' cylinders.
__device__ void stream_run(const float* __restrict__ pts, int n, int lo,
                           int hi, int s, const int* __restrict__ key,
                           const float* __restrict__ normal,
                           const int* __restrict__ dep,
                           const int* __restrict__ dep_count, int D,
                           const Geo& g, float radius,
                           float* __restrict__ cyl_stats, int wl) {
    int cnt = wl == 0 ? dep_count[s] : 0;
    cnt = min(__shfl_sync(FULL_MASK, cnt, 0), D);
    for (int jb = 0; jb < cnt; jb += 32) {
        // lane wl holds owner jb + wl: its slot, center and normal
        int own = -1;
        float c[3] = {0.f, 0.f, 0.f}, nv[3] = {0.f, 0.f, 0.f};
        if (jb + wl < cnt) {
            own = dep[(long)s * D + jb + wl];
            if (own >= 0) {
                center_of_id(g, key[own], c);
                for (int a = 0; a < 3; ++a) nv[a] = normal[3L * own + a];
            }
        }
        const int jn = min(cnt - jb, 32);
        for (int j = 0; j < jn; ++j) {
            const int o = __shfl_sync(FULL_MASK, own, j);
            if (o < 0) continue;
            float cj[3], nj[3];
            for (int a = 0; a < 3; ++a) {
                cj[a] = __shfl_sync(FULL_MASK, c[a], j);
                nj[a] = __shfl_sync(FULL_MASK, nv[a], j);
            }
            float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
            for (int i = lo + wl; i < hi; i += 32) {
                const float p[3] = {pts[i], pts[(long)n + i],
                                    pts[2L * n + i]};
                float t, d;
                if (cylinder_hit(p, cj, nj, radius, t, d)) {
                    acc[0] = __fadd_rn(acc[0], t);
                    acc[1] = __fadd_rn(acc[1], __fmul_rn(t, t));
                    acc[2] = __fadd_rn(acc[2], d);
                    acc[3] = __fadd_rn(acc[3], __fmul_rn(d, d));
                    acc[4] = __fadd_rn(acc[4], 1.0f);
                }
            }
            for (int m = 16; m > 0; m >>= 1)
                for (int a = 0; a < 5; ++a)
                    acc[a] = __fadd_rn(
                        acc[a], __shfl_xor_sync(FULL_MASK, acc[a], m));
            if (wl == 0 && acc[4] > 0.0f) {
                float* cs = cyl_stats + 5L * o;
                for (int a = 0; a < 5; ++a) atomicAdd(cs + a, acc[a]);
            }
        }
    }
}

// The runs that close inside the 32-lane window [pos, pos + 32), one group
// of lanes each, all at once.  head: the group's first lane, last: its
// last; active: the lane's run is complete, owned by this warp and placed.
__device__ void stream_window(const float* __restrict__ pts, int n, int pos,
                              int s, bool active, int head, int last,
                              const int* __restrict__ key,
                              const float* __restrict__ normal,
                              const int* __restrict__ dep,
                              const int* __restrict__ dep_count, int D,
                              const Geo& g, float radius,
                              float* __restrict__ cyl_stats, int wl) {
    const int size = last - head + 1;
    const int rank = wl - head;
    // the head reads dep_count while the group's lanes read its first owners
    int cnt = active && rank == 0 ? dep_count[s] : 0;
    int own = active && rank < D ? dep[(long)s * D + rank] : -1;
    float p[3] = {0.f, 0.f, 0.f};
    if (active)
        for (int a = 0; a < 3; ++a) p[a] = pts[(long)a * n + pos + wl];
    cnt = min(__shfl_sync(FULL_MASK, cnt, head), D);
    const uint32_t group = (uint32_t)((2ull << last) - (1ull << head));
    const int span = __reduce_max_sync(FULL_MASK, active ? size : 1);
    // owner j of the group sits on lane head + j % size in round j / size
    const int rounds = __reduce_max_sync(
        FULL_MASK, active ? (cnt + size - 1) / size : 0);
    for (int q = 0; q < rounds; ++q) {
        const int jo = q * size + rank;
        if (q > 0) own = active && jo < D ? dep[(long)s * D + jo] : -1;
        if (!(active && jo < cnt)) own = -1;
        float c[3] = {0.f, 0.f, 0.f}, nv[3] = {0.f, 0.f, 0.f};
        if (own >= 0) {
            center_of_id(g, key[own], c);
            for (int a = 0; a < 3; ++a) nv[a] = normal[3L * own + a];
        }
        const int jn = __reduce_max_sync(
            FULL_MASK, active ? max(min(size, cnt - q * size), 0) : 0);
        for (int jj = 0; jj < jn; ++jj) {
            const bool listed = active && jj < size && q * size + jj < cnt;
            const int src = listed ? head + jj : wl;
            const int o = __shfl_sync(FULL_MASK, own, src);
            float cj[3], nj[3];
            for (int a = 0; a < 3; ++a) {
                cj[a] = __shfl_sync(FULL_MASK, c[a], src);
                nj[a] = __shfl_sync(FULL_MASK, nv[a], src);
            }
            float t = 0.f, d = 0.f;
            const bool hit = listed && o >= 0
                             && cylinder_hit(p, cj, nj, radius, t, d);
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            if (hit) {
                acc[0] = t;
                acc[1] = __fmul_rn(t, t);
                acc[2] = d;
                acc[3] = __fmul_rn(d, d);
            }
            // segmented sum down to the head: lane l adds lane l + off
            // while that lane is still in its group
            for (int off = 1; off < span; off <<= 1)
                for (int a = 0; a < 4; ++a) {
                    const float x = __shfl_down_sync(FULL_MASK, acc[a], off);
                    if (wl + off <= last) acc[a] = __fadd_rn(acc[a], x);
                }
            const int hits = __popc(__ballot_sync(FULL_MASK, hit) & group);
            if (rank == 0 && hits > 0) {
                float* cs = cyl_stats + 5L * o;
                for (int a = 0; a < 4; ++a) atomicAdd(cs + a, acc[a]);
                atomicAdd(cs + 4, (float)hits);
            }
        }
    }
}

__global__ void __launch_bounds__(32 * K3_WARPS)
dep_stream_kernel(const float* __restrict__ pts, int n,
                  const int* __restrict__ slots, const int* __restrict__ key,
                  const float* __restrict__ normal,
                  const int* __restrict__ dep,
                  const int* __restrict__ dep_count, int D, Geo g,
                  float radius, float* __restrict__ cyl_stats) {
    const int wl = threadIdx.x & 31;
    const long warp = (long)blockIdx.x * K3_WARPS + (threadIdx.x >> 5);
    if (warp * K3_CHUNK >= n) return;           // the whole warp
    const int lo = (int)(warp * K3_CHUNK);
    const int hi = min(lo + K3_CHUNK, n);
    int pos = lo;
    // a run that began in an earlier chunk belongs to that chunk's warp
    if (pos > 0 && slots[pos - 1] == slots[pos])
        pos = next_change(slots, pos + 1, hi, slots[pos], wl);
    while (pos < hi) {
        const int s = pos + wl < n ? slots[pos + wl] : K3_PAST_END;
        const int after = pos + 32 < n ? slots[pos + 32] : K3_PAST_END;
        const int up = __shfl_up_sync(FULL_MASK, s, 1);
        const uint32_t heads = __ballot_sync(FULL_MASK, wl == 0 || up != s);
        const int last_head = 31 - __clz(heads);
        const bool open = after != K3_PAST_END
                          && __shfl_sync(FULL_MASK, s, 31) == after;
        if (open && last_head == 0) {
            // one run fills the window and goes on: stream it whole
            const int end = next_change(slots, pos + 32, s >= 0 ? n : hi, s,
                                        wl);
            if (s >= 0)
                stream_run(pts, n, pos, end, s, key, normal, dep, dep_count,
                           D, g, radius, cyl_stats, wl);
            pos = end;
            continue;
        }
        const int head = 31 - __clz(heads & (FULL_MASK >> (31 - wl)));
        const uint32_t later = wl == 31 ? 0u : heads >> (wl + 1);
        const int last = later ? wl + __ffs(later) - 1 : 31;
        const bool active = s >= 0 && pos + head < hi
                            && !(open && head == last_head);
        stream_window(pts, n, pos, s, active, head, last, key, normal, dep,
                      dep_count, D, g, radius, cyl_stats, wl);
        pos += open ? last_head : 32;
    }
}

extern "C" int launch_dep_stream(const void* pts, int n, const void* slots,
                                 const void* key, const void* normal,
                                 const void* dep, const void* dep_count,
                                 int D, const float* geo_f, const int* geo_i,
                                 float radius, void* cyl_stats,
                                 void* stream) {
    if (n == 0) return 0;
    const int threads = 32 * K3_WARPS;
    dep_stream_kernel<<<grid_blocks(n, K3_CHUNK * K3_WARPS), threads, 0,
                        (cudaStream_t)stream>>>(
        (const float*)pts, n, (const int*)slots, (const int*)key,
        (const float*)normal, (const int*)dep, (const int*)dep_count, D,
        make_geo(geo_f, geo_i), radius, (float*)cyl_stats);
    return (int)cudaGetLastError();
}
