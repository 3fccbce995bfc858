// Shared definitions of the port's CUDA kernels.
//
// Every kernel takes the grid geometry as one by-value struct built on the
// host from two small arrays (kernels/__init__.py geometry_args): origin,
// resolution, bbox lower and upper corners, the f32 reciprocal resolution
// (f32), the grid dims and the local->global coordinate offset (i32).  A
// cell coordinate is floor((p - origin) * inv_res), as XLA computes the
// JAX package's division by the constant resolution (ops/geometry.py
// cell_coords), minus the offset: a shard of a slab-sharded grid
// (parallel/sharding.py) addresses its slab and halo in local
// coordinates, while world arithmetic and cell centers stay global.  A
// single grid has offset 0.
// Floating-point arithmetic that feeds a floor or a strict comparison is
// written with round-to-nearest intrinsics in the JAX package's operation
// order, so no fused multiply-add can move a result by one rounding.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct Geo {
    float origin[3];
    float res[3];
    float lo[3];
    float hi[3];
    float inv_res[3];
    int dims[3];
    int off[3];
};

static inline Geo make_geo(const float* f, const int* i) {
    Geo g;
    for (int a = 0; a < 3; ++a) {
        g.origin[a] = f[a];
        g.res[a] = f[3 + a];
        g.lo[a] = f[6 + a];
        g.hi[a] = f[9 + a];
        g.inv_res[a] = f[12 + a];
        g.dims[a] = i[a];
        g.off[a] = i[3 + a];
    }
    return g;
}

// murmur3 fmix32 finalizer (hifi_fusion_tpu/ops/hashing.py hash_u32)
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    h ^= h >> 16;
    return h;
}

// dense id -> local coords -> global center, as geometry.center_of_ids:
// fma(res, (coord + off) + 0.5, origin), rounded once (the fused
// multiply-add XLA makes of the JAX package's origin + res * (c + 0.5))
__device__ __forceinline__ void center_of_id(const Geo& g, int id,
                                             float* c) {
    int z = id % g.dims[2];
    int xy = id / g.dims[2];
    int y = xy % g.dims[1];
    int x = xy / g.dims[1];
    int v[3] = {x, y, z};
    for (int a = 0; a < 3; ++a)
        c[a] = __fmaf_rn(g.res[a], __fadd_rn((float)(v[a] + g.off[a]), 0.5f),
                         g.origin[a]);
}

// The cylinder gate of kernels K3 (dep_stream.cu) and B7
// (buffer_replay.cu): point p against the cylinder of an owner with center
// c and unit normal nv, in the operation order of the plain versions
// (ops/integrate.py cylinder_add) and the JAX package: q = p - c, t =
// (q0 n0 + q1 n1) + q2 n2, r = q - t n, d = sqrt((r0^2 + r1^2) + r2^2),
// each step rounded on its own; returns d < radius with t and d.
__device__ __forceinline__ bool cylinder_hit(const float* p, const float* c,
                                             const float* nv, float radius,
                                             float& t, float& d) {
    float q[3];
    for (int a = 0; a < 3; ++a) q[a] = __fsub_rn(p[a], c[a]);
    t = __fadd_rn(__fadd_rn(__fmul_rn(q[0], nv[0]), __fmul_rn(q[1], nv[1])),
                  __fmul_rn(q[2], nv[2]));
    float r[3];
    for (int a = 0; a < 3; ++a) r[a] = __fsub_rn(q[a], __fmul_rn(t, nv[a]));
    d = __fsqrt_rn(__fadd_rn(
        __fadd_rn(__fmul_rn(r[0], r[0]), __fmul_rn(r[1], r[1])),
        __fmul_rn(r[2], r[2])));
    return d < radius;
}

// The frontend arithmetic shared by kernels K1 (depth_frontend.cu), K5
// (planar_frontend.cu) and B12 (route_pack.cu), so that routed and
// replicated ingests agree bit for bit on which points survive.

// SE(3) transform by the row-major (4,4) pose T in the JAX package's
// order: ((R0 p0 + R1 p1) + R2 p2) + t, one rounding per operation
__device__ __forceinline__ void pose_transform(const float* T,
                                               const float* p, float* w) {
    for (int a = 0; a < 3; ++a) {
        const float* r = T + 4 * a;
        w[a] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r[0], p[0]),
                                             __fmul_rn(r[1], p[1])),
                                   __fmul_rn(r[2], p[2])),
                         r[3]);
    }
}

// the local cell coords floor((w - origin) * inv_res) - off of a world
// point; returns whether they lie inside [0, dims) and, with ``bbox``,
// the point strictly inside the bbox (a pre-transformed routed point was
// bbox-tested by its router)
__device__ __forceinline__ bool cell_coords_valid(const Geo& g,
                                                  const float* w, int* c,
                                                  bool bbox) {
    bool valid = true;
    for (int a = 0; a < 3; ++a) {
        if (bbox) valid = valid && w[a] > g.lo[a] && w[a] < g.hi[a];
        const float f =
            floorf(__fmul_rn(__fsub_rn(w[a], g.origin[a]), g.inv_res[a]));
        c[a] = (int)f - g.off[a];
        valid = valid && c[a] >= 0 && c[a] < g.dims[a];
    }
    return valid;
}

// rgb565 -> 8-bit channels (x8, x4, x8)
__device__ __forceinline__ void expand_565(unsigned v, float* col) {
    col[0] = (float)((v >> 11) & 0x1Fu) * 8.0f;
    col[1] = (float)((v >> 5) & 0x3Fu) * 4.0f;
    col[2] = (float)(v & 0x1Fu) * 8.0f;
}

// The occupancy window of kernels K4 (normal_fit.cu) and B11
// (neighbor_count.cu): column c of the (2k+1)^2 (dx, dy) columns of a
// window around cell (cx, cy, cz), read from the cell-id-keyed bitmap
// as two 32-bit words cut to the column's (2k+1)-bit z window.

// the bitmap bit of cell (cx + dx, cy + dy, cz) for column c = (dx + k) *
// S + (dy + k) of the window, or -1 for a column past NC or outside the
// grid
__device__ __forceinline__ int column_base(const Geo& g, int cx, int cy,
                                          int cz, int c, int S, int k,
                                          int NC) {
    const int nx = cx + c / S - k, ny = cy + c % S - k;
    if (c >= NC || nx < 0 || nx >= g.dims[0] || ny < 0 || ny >= g.dims[1])
        return -1;
    return (nx * g.dims[1] + ny) * g.dims[2] + cz;
}

// the column's z window: bit t = dz + k holds cell (.., cz + dz), from
// the two bitmap words at and after bit shpos = max(colbase - k, 0), the
// words the JAX package reads; bit t lies at bit t - off of the 32 bits
// from shpos, where off > 0 only near the bitmap's start (bitpos < 0)
__device__ __forceinline__ uint32_t column_window(uint32_t w0, uint32_t w1,
                                                  int colbase, int k,
                                                  uint32_t zmask) {
    const int shpos = max(colbase - k, 0);
    const int off = shpos - (colbase - k);
    const uint32_t b0 = (uint32_t)(shpos & 31);
    const uint32_t win = (w0 >> b0) | (b0 > 0 ? w1 << (32 - b0) : 0u);
    return (win << off) & zmask;
}

// the z bits t of a column's window whose cell cz + t - k lies inside the
// grid
__device__ __forceinline__ uint32_t z_window_mask(const Geo& g, int cz,
                                                  int k) {
    const int zlo = max(0, k - cz);
    const int zhi = min(2 * k, g.dims[2] - 1 - cz + k);
    return zhi < zlo ? 0u : (((2u << zhi) - 1u) & ~((1u << zlo) - 1u));
}

// the cell id of an invalid lane or an empty id lane (INT32_MAX), as the
// Python side's INVALID_ID
constexpr int INVALID_ID = 0x7fffffff;

static inline int grid_blocks(long n, int threads) {
    long b = (n + threads - 1) / threads;
    return (int)(b < 1 ? 1 : b);
}
