// Kernel K3: the dependant cylinder stream of an integrate batch.
//
// Replaces: the dependant streaming of integrate_frame_impl in
// hifi_fusion_tpu/ops/integrate.py (_pair_block :590-766 and
// _resid_block :512-588).  There, owner constants reach point lanes
// through an owner sort, run-start gathers, segment fills and a sort back,
// and per-owner sums through segmented scans, because random gathers are
// slow on a TPU.  On the card an owner's constants are read directly.
//
// Bound on the card: scattered loads and atomics.  For each valid point
// (up to K*N = 2.46 M at the bench size) the thread reads its cell's
// dep_count and up to D=10 owner slots, then per owner the owner's key
// (4 B) and normal (12 B): ~16 B of mostly L2-resident reads per
// (point, owner) pair, and 5 f32 atomicAdds per cylinder hit.  Points of
// one cell are adjacent after the frame sort, so their owners' constants
// and cyl_stats rows are shared by neighbouring threads.
//
// Design: one thread per sorted point lane.  For j < min(dep_count, D),
// skipping dep < 0: center = fma(res, coord + 0.5, origin) from key[owner],
// q = p - c, t = q.n, r = q - t*n, d = |r| in the JAX operation order with
// round-to-nearest intrinsics, so the gate d < cylinder_radius decides
// exactly as the plain version does; on a hit [t, t^2, d, d^2, 1] is added
// to cyl_stats[5*owner ..] with atomicAdd.  The hit channel is an
// integer-valued f32 below 2^24 and therefore exact; the other four sums
// differ from the plain version only in addition order.  A deterministic
// per-owner reduction is later work.

#include "common.cuh"

__global__ void dep_stream_kernel(const float* __restrict__ pts, int n,
                                  const int* __restrict__ slots,
                                  const int* __restrict__ key,
                                  const float* __restrict__ normal,
                                  const int* __restrict__ dep,
                                  const int* __restrict__ dep_count, int D,
                                  Geo g, float radius,
                                  float* __restrict__ cyl_stats) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int s = slots[i];
    if (s < 0) return;
    const int cnt = min(dep_count[s], D);
    const float p[3] = {pts[i], pts[n + i], pts[2L * n + i]};
    for (int j = 0; j < cnt; ++j) {
        const int o = dep[(long)s * D + j];
        if (o < 0) continue;
        float c[3];
        center_of_id(g, key[o], c);
        const float nv[3] = {normal[3L * o], normal[3L * o + 1],
                             normal[3L * o + 2]};
        float q[3];
        for (int a = 0; a < 3; ++a) q[a] = __fsub_rn(p[a], c[a]);
        const float t = __fadd_rn(__fadd_rn(__fmul_rn(q[0], nv[0]),
                                            __fmul_rn(q[1], nv[1])),
                                  __fmul_rn(q[2], nv[2]));
        float r[3];
        for (int a = 0; a < 3; ++a)
            r[a] = __fsub_rn(q[a], __fmul_rn(t, nv[a]));
        const float d = __fsqrt_rn(__fadd_rn(
            __fadd_rn(__fmul_rn(r[0], r[0]), __fmul_rn(r[1], r[1])),
            __fmul_rn(r[2], r[2])));
        if (d < radius) {
            float* cs = cyl_stats + 5L * o;
            atomicAdd(cs, t);
            atomicAdd(cs + 1, __fmul_rn(t, t));
            atomicAdd(cs + 2, d);
            atomicAdd(cs + 3, __fmul_rn(d, d));
            atomicAdd(cs + 4, 1.0f);
        }
    }
}

extern "C" int launch_dep_stream(const void* pts, int n, const void* slots,
                                 const void* key, const void* normal,
                                 const void* dep, const void* dep_count,
                                 int D, const float* geo_f, const int* geo_i,
                                 float radius, void* cyl_stats,
                                 void* stream) {
    if (n == 0) return 0;
    const int threads = 256;
    dep_stream_kernel<<<grid_blocks(n, threads), threads, 0,
                        (cudaStream_t)stream>>>(
        (const float*)pts, n, (const int*)slots, (const int*)key,
        (const float*)normal, (const int*)dep, (const int*)dep_count, D,
        make_geo(geo_f, geo_i), radius, (float*)cyl_stats);
    return (int)cudaGetLastError();
}
