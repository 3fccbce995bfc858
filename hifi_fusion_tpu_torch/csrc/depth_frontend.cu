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
// constant resolution, common.cuh) minus the shard offset, local coord
// validity, dense cell id, and the rgb565 expansion (x8, x4, x8).
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
    float w[3];
    pose_transform(poses + 16L * k, p, w);
    int c[3];
    const bool inside = cell_coords_valid(g, w, c, true);
    const bool valid =
        n < counts[k] && dq > 0 && p[2] > zmin && p[2] < zmax && inside;
    ids[lane] = valid ? (c[0] * g.dims[1] + c[1]) * g.dims[2] + c[2]
                      : INT_MAX;
    world[lane] = w[0];
    world[M + lane] = w[1];
    world[2 * M + lane] = w[2];
    float col[3];
    expand_565(rgb565[lane], col);
    rgb[lane] = col[0];
    rgb[M + lane] = col[1];
    rgb[2 * M + lane] = col[2];
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
