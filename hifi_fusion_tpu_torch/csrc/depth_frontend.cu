// Kernel K1: the sensor-native depth frontend of a K-frame batch.
//
// Replaces: the Pallas kernel transform_clip_cellid (P1, deleted in
// d3b2b84; hifi_fusion_tpu/ops/pallas_kernels.py) whose job the JAX
// package inlined into the batched depth ingest: the depth branch of
// _unpack_inputs (hifi_fusion_tpu/ops/integrate.py:110-175) and the
// batched frontend (integrate.py:241-287).  Per (frame, pixel) lane:
// unproject u16 depth against the resident ray table, count-prefix and
// zero-depth validity, camera-z clip, SE(3) pose transform, strict bbox
// test, floor((w - origin) * inv_res) (XLA's form of the division by the
// constant resolution, common.cuh), coord validity, dense cell id, and
// the rgb565 expansion (x8, x4, x8).
//
// Bound on the card: memory.  A lane reads 4 B of wire (depth, rgb565) and
// 12 B of rays and writes 28 B (world xyz, id, rgb), about 44 B; a K=8
// batch of 640x480 frames moves ~108 MB, ~32 us at 3.35 TB/s.  The
// arithmetic (~30 flops a lane) is far below the card's rate.
//
// Design: one thread per lane over the flat (K*N) lane space, frame-major,
// so neighbouring threads touch neighbouring addresses in every planar
// array.  The per-frame pose (16 floats) is read through the cache.  All
// f32 math uses round-to-nearest intrinsics in the JAX operation order:
// a cell id is a floor, so one contracted multiply-add would move a
// borderline point into another cell.  Bit-exact against the plain
// version (ops/integrate.py depth_frontend_plain).

#include <limits.h>

#include "common.cuh"

__global__ void depth_frontend_kernel(
    const unsigned short* __restrict__ depth,
    const unsigned short* __restrict__ rgb565,
    const int* __restrict__ counts, const float* __restrict__ poses,
    const float* __restrict__ rays, int K, int N, Geo g, float zmin,
    float zmax, float* __restrict__ world, int* __restrict__ ids,
    float* __restrict__ rgb) {
    const long M = (long)K * N;
    long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= M) return;
    const int k = (int)(lane / N);
    const int n = (int)(lane - (long)k * N);

    const unsigned short dq = depth[lane];
    const float d = (float)dq;
    const float p[3] = {__fmul_rn(d, rays[n]), __fmul_rn(d, rays[N + n]),
                        __fmul_rn(d, rays[2L * N + n])};
    const float* P = poses + 16L * k;
    float w[3];
    for (int a = 0; a < 3; ++a) {
        const float* r = P + 4 * a;
        w[a] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(r[0], p[0]),
                                             __fmul_rn(r[1], p[1])),
                                   __fmul_rn(r[2], p[2])),
                         r[3]);
    }
    bool valid = n < counts[k] && dq > 0 && p[2] > zmin && p[2] < zmax;
    int c[3];
    for (int a = 0; a < 3; ++a) {
        valid = valid && w[a] > g.lo[a] && w[a] < g.hi[a];
        const float f =
            floorf(__fmul_rn(__fsub_rn(w[a], g.origin[a]), g.inv_res[a]));
        c[a] = (int)f;
        valid = valid && c[a] >= 0 && c[a] < g.dims[a];
    }
    ids[lane] = valid ? (c[0] * g.dims[1] + c[1]) * g.dims[2] + c[2]
                      : INT_MAX;
    world[lane] = w[0];
    world[M + lane] = w[1];
    world[2 * M + lane] = w[2];
    const unsigned v = rgb565[lane];
    rgb[lane] = (float)((v >> 11) & 0x1Fu) * 8.0f;
    rgb[M + lane] = (float)((v >> 5) & 0x3Fu) * 4.0f;
    rgb[2 * M + lane] = (float)(v & 0x1Fu) * 8.0f;
}

extern "C" int launch_depth_frontend(
    const void* depth, const void* rgb565, const void* counts,
    const void* poses, const void* rays, int K, int N, const float* geo_f,
    const int* geo_i, float zmin, float zmax, void* world, void* ids,
    void* rgb, void* stream) {
    const int threads = 256;
    const long M = (long)K * N;
    depth_frontend_kernel<<<grid_blocks(M, threads), threads, 0,
                            (cudaStream_t)stream>>>(
        (const unsigned short*)depth, (const unsigned short*)rgb565,
        (const int*)counts, (const float*)poses, (const float*)rays, K, N,
        make_geo(geo_f, geo_i), zmin, zmax, (float*)world, (int*)ids,
        (float*)rgb);
    return (int)cudaGetLastError();
}

extern "C" const char* hifi_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
