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
// Bound on the card: latency of dependent random loads, and the sectors
// they touch.  Each surface cell reads its own vstats row, finds its 6
// face neighbours in the key table (one probe each at the table's load of
// ~0.08) and reads their (w, Σsdf) pairs: ~14-20 scattered 32-byte
// sectors a cell against a 64 MB key table and a 403 MB vstats array
// (config 5), which puts the floor at ~0.03-0.04 ms for ~0.2-0.3 M cells,
// well above the 148 B a cell of bounds.py's word count.
//
// Design: one thread per surface cell, three dependent trips instead of
// six chains of two or three: (1) the cell's id and slot; (2) every
// face's first probe of the key table, issued before any is used, beside
// the cell's own row (three 8-byte loads); (3) the neighbours' (w, Σsdf)
// pairs as one 8-byte load each.  A probe that meets another id walks on
// in K2's sequence (fmix32 + triangular offsets) up to max_probes, as
// hifi_fusion_tpu/ops/hashing.py lookup does; at the table's load that is
// rare.  The z neighbours (id +- 1) come from the sorted list itself
// when they are surface cells (cell[e +- 1], order[e +- 1], which the
// neighbouring threads load anyway), with no probe.

#include "common.cuh"

__device__ __forceinline__ float mean_sdf(float w, float sdf) {
    return __fdiv_rn(sdf, fmaxf(w, 1e-9f));
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

    // face f = 2 * axis + i: the neighbour at +1 (i = 0) or -1 (i = 1)
    int nid[6];
    int sl[6];                 // slot, -1 missing, -2 still to probe
#pragma unroll
    for (int f = 0; f < 6; ++f) {
        int cc[3] = {c[0], c[1], c[2]};
        cc[f >> 1] += (f & 1) ? -1 : 1;
        const bool ok = cc[0] >= 0 && cc[0] < g.dims[0] && cc[1] >= 0
                        && cc[1] < g.dims[1] && cc[2] >= 0
                        && cc[2] < g.dims[2];
        nid[f] = (cc[0] * g.dims[1] + cc[1]) * g.dims[2] + cc[2];
        sl[f] = ok ? -2 : -1;
    }
    if (sl[4] == -2 && e + 1 < E && cell[e + 1] == id + 1)
        sl[4] = order[e + 1];
    if (sl[5] == -2 && e > 0 && cell[e - 1] == id - 1) sl[5] = order[e - 1];

    // trip 2: every first probe at once, beside the cell's own row
    uint32_t h[6];
    int k0[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) {
        h[f] = fmix32((uint32_t)nid[f]);
        k0[f] = sl[f] == -2 ? key[h[f] & mask] : -1;
    }
    const float2* own = (const float2*)(vstats + 6 * slot);
    const float2 wsdf = own[0], rg = own[1], bn = own[2];
#pragma unroll
    for (int f = 0; f < 6; ++f) {
        if (sl[f] != -2) continue;
        if (k0[f] == nid[f]) {
            sl[f] = (int)(h[f] & mask);
            continue;
        }
        sl[f] = -1;
        if (k0[f] == -1) continue;
        for (uint32_t j = 1; j < (uint32_t)max_probes; ++j) {
            const int s = (int)((h[f] + ((j * (j + 1u)) >> 1)) & mask);
            const int k = key[s];
            if (k == nid[f]) {
                sl[f] = s;
                break;
            }
            if (k == -1) break;
        }
    }

    // trip 3: the neighbours' (w, Σsdf) pairs at once
    float2 nv[6];
#pragma unroll
    for (int f = 0; f < 6; ++f)
        nv[f] = sl[f] >= 0 ? *(const float2*)(vstats + 6L * sl[f])
                           : make_float2(0.0f, 0.0f);

    const float t_here = mean_sdf(wsdf.x, wsdf.y);
    float grad[3];
#pragma unroll
    for (int axis = 0; axis < 3; ++axis) {
        float val[2];
        bool has[2];
        for (int i = 0; i < 2; ++i) {
            const float2 v = nv[2 * axis + i];
            has[i] = sl[2 * axis + i] >= 0 && v.x > 0.0f;
            val[i] = has[i] ? mean_sdf(v.x, v.y) : t_here;
        }
        const float span = __fmul_rn(
            __fadd_rn(has[0] ? 1.0f : 0.0f, has[1] ? 1.0f : 0.0f),
            g.res[axis]);
        grad[axis] = __fdiv_rn(__fsub_rn(val[0], val[1]),
                               fmaxf(span, 1e-9f));
    }
    float center[3];
    center_of_id(g, id, center);
    const float gnorm = __fsqrt_rn(__fmaf_rn(
        grad[2], grad[2],
        __fmaf_rn(grad[1], grad[1], __fmul_rn(grad[0], grad[0]))));
    const bool ok = gnorm > 1e-9f;
    const float inv = __fdiv_rn(1.0f, ok ? gnorm : 1.0f);
    const float nvec[3] = {__fmul_rn(grad[0], inv), __fmul_rn(grad[1], inv),
                           ok ? __fmul_rn(grad[2], inv) : 1.0f};
    const float nrgb = fmaxf(bn.y, 1.0f);
    const float col[3] = {rg.x, rg.y, bn.x};
    for (int a = 0; a < 3; ++a) {
        normal[(long)a * E + e] = nvec[a];
        centroid[(long)a * E + e] = __fmaf_rn(-t_here, nvec[a], center[a]);
        rgb[(long)a * E + e] = __fdiv_rn(col[a], nrgb);
    }
    tsdf[e] = t_here;
    weight[e] = wsdf.x;
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
