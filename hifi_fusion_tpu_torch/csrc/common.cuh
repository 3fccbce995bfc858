// Shared definitions of the port's CUDA kernels (K1-K4).
//
// Every kernel takes the grid geometry as one by-value struct built on the
// host from two small arrays (kernels/__init__.py geometry_args): origin,
// resolution, bbox lower and upper corners (f32) and the grid dims (i32).
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
    int dims[3];
};

static inline Geo make_geo(const float* f, const int* i) {
    Geo g;
    for (int a = 0; a < 3; ++a) {
        g.origin[a] = f[a];
        g.res[a] = f[3 + a];
        g.lo[a] = f[6 + a];
        g.hi[a] = f[9 + a];
        g.dims[a] = i[a];
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

// dense id -> coords -> center, as geometry.center_of_ids:
// fma(res, coord + 0.5, origin), rounded once (the fused multiply-add XLA
// makes of the JAX package's origin + res * (coord + 0.5))
__device__ __forceinline__ void center_of_id(const Geo& g, int id,
                                             float* c) {
    int z = id % g.dims[2];
    int xy = id / g.dims[2];
    int y = xy % g.dims[1];
    int x = xy / g.dims[1];
    int v[3] = {x, y, z};
    for (int a = 0; a < 3; ++a)
        c[a] = __fmaf_rn(g.res[a], __fadd_rn((float)v[a], 0.5f),
                         g.origin[a]);
}

static inline int grid_blocks(long n, int threads) {
    long b = (n + threads - 1) / threads;
    return (int)(b < 1 ? 1 : b);
}
