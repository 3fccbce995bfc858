// Kernel T3: the TSDF family's per-surface-cell extraction.
//
// Replaces: the per-cell half of extract_tsdf_impl
// (hifi_fusion_tpu/models/tsdf.py:262-298), which runs after the surface
// mask and the id sort: the cell center, the TSDF gradient by central
// differences over the 6 hash-looked-up neighbours (one-sided where a
// neighbour is missing or has no weight), the normal (z = 1 where the
// gradient vanishes), the centroid center - tsdf * normal, and the mean
// colour.  On the card it also replaces the port's plain hashing.lookup
// loop, which synchronises once per probe round.
//
// Operation for operation as the plain version (models/tsdf.py
// tsdf_surface_plain), divisions true (round-to-nearest intrinsics,
// -fmad=false): bit-exact against it.  Against the JAX package on the CPU
// the normal holds to 1e-5 and the centroid to 1e-6 (checks.py): XLA's
// contraction of the gradient's sum of squares varies with its fusion;
// the centroid is one fused multiply-add, as XLA makes it.
//
// Bound on the card: latency of dependent random loads.  Each surface
// cell probes the key table for 6 neighbours (1-3 probes each at the
// table's load) and reads their two vstats words: ~20 scattered 4 B
// loads a cell.  At ~0.3 M surface cells against a 64 MB key table and a
// 403 MB vstats array (config 5) that is a few million L2-missing loads.
//
// Design: one thread per surface cell; the probe sequence is K2's
// (fmix32 + triangular offsets), stopping at the id or at an empty slot
// within max_probes, as hifi_fusion_tpu/ops/hashing.py lookup does.

#include "common.cuh"

__device__ __forceinline__ int probe_lookup(const int* __restrict__ key,
                                            int id, uint32_t mask,
                                            int max_probes) {
    const uint32_t h = fmix32((uint32_t)id);
    for (uint32_t j = 0; j < (uint32_t)max_probes; ++j) {
        const int s = (int)((h + ((j * (j + 1u)) >> 1)) & mask);
        const int k = key[s];
        if (k == id) return s;
        if (k == -1) return -1;
    }
    return -1;
}

__device__ __forceinline__ float mean_sdf(const float* __restrict__ vstats,
                                          long slot) {
    return __fdiv_rn(vstats[6 * slot + 1], fmaxf(vstats[6 * slot], 1e-9f));
}

__global__ void tsdf_surface_kernel(
    const int* __restrict__ cell, const int* __restrict__ order, int E,
    const int* __restrict__ key, const float* __restrict__ vstats,
    uint32_t mask, int max_probes, Geo g, float* __restrict__ centroid,
    float* __restrict__ normal, float* __restrict__ tsdf,
    float* __restrict__ weight, float* __restrict__ rgb) {
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= E) return;
    const int id = cell[e];
    const long slot = order[e];
    const int z = id % g.dims[2];
    const int xy = id / g.dims[2];
    const int c[3] = {xy / g.dims[1], xy % g.dims[1], z};
    float center[3];
    center_of_id(g, id, center);
    const float* v = vstats + 6 * slot;
    const float t_here = mean_sdf(vstats, slot);

    float grad[3];
    for (int axis = 0; axis < 3; ++axis) {
        float val[2];
        bool has[2];
        for (int i = 0; i < 2; ++i) {
            int cc[3] = {c[0], c[1], c[2]};
            cc[axis] += i == 0 ? 1 : -1;
            const bool ok = cc[0] >= 0 && cc[0] < g.dims[0] && cc[1] >= 0
                            && cc[1] < g.dims[1] && cc[2] >= 0
                            && cc[2] < g.dims[2];
            const int sl =
                ok ? probe_lookup(key,
                                  (cc[0] * g.dims[1] + cc[1]) * g.dims[2]
                                      + cc[2],
                                  mask, max_probes)
                   : -1;
            has[i] = sl >= 0 && vstats[6L * sl] > 0.0f;
            val[i] = has[i] ? mean_sdf(vstats, sl) : t_here;
        }
        const float span = __fmul_rn(
            __fadd_rn(has[0] ? 1.0f : 0.0f, has[1] ? 1.0f : 0.0f),
            g.res[axis]);
        grad[axis] = __fdiv_rn(__fsub_rn(val[0], val[1]),
                               fmaxf(span, 1e-9f));
    }
    const float gnorm = __fsqrt_rn(__fmaf_rn(
        grad[2], grad[2],
        __fmaf_rn(grad[1], grad[1], __fmul_rn(grad[0], grad[0]))));
    const bool ok = gnorm > 1e-9f;
    const float inv = __fdiv_rn(1.0f, ok ? gnorm : 1.0f);
    const float nv[3] = {__fmul_rn(grad[0], inv), __fmul_rn(grad[1], inv),
                         ok ? __fmul_rn(grad[2], inv) : 1.0f};
    const float nrgb = fmaxf(v[5], 1.0f);
    for (int a = 0; a < 3; ++a) {
        normal[(long)a * E + e] = nv[a];
        centroid[(long)a * E + e] = __fmaf_rn(-t_here, nv[a], center[a]);
        rgb[(long)a * E + e] = __fdiv_rn(v[2 + a], nrgb);
    }
    tsdf[e] = t_here;
    weight[e] = v[0];
}

extern "C" int launch_tsdf_surface(
    const void* cell, const void* order, int E, const void* key,
    const void* vstats, int capacity, int max_probes, const float* geo_f,
    const int* geo_i, void* centroid, void* normal, void* tsdf,
    void* weight, void* rgb, void* stream) {
    if (E == 0) return 0;
    const int threads = 128;
    tsdf_surface_kernel<<<grid_blocks(E, threads), threads, 0,
                          (cudaStream_t)stream>>>(
        (const int*)cell, (const int*)order, E, (const int*)key,
        (const float*)vstats, (uint32_t)(capacity - 1), max_probes,
        make_geo(geo_f, geo_i), (float*)centroid, (float*)normal,
        (float*)tsdf, (float*)weight, (float*)rgb);
    return (int)cudaGetLastError();
}
