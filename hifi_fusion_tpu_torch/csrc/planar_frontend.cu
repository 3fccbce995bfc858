// Kernel K5: the planar frontend of a K-frame batch of point clouds.
//
// Replaces: the Pallas kernel transform_clip_cellid (P1, deleted in
// d3b2b84; hifi_fusion_tpu/ops/pallas_kernels.py, def :67, pallas_call
// :83) on its own input, planar (3,N) camera points with a lane mask and
// a pose, and the planar wires the JAX package decodes ahead of it
// (_unpack_inputs, hifi_fusion_tpu/ops/integrate.py:110-175; the batched
// frontend, :257-287).  Per (frame, point) lane: dequantize u16 points
// as q * scale + offset (or read f32 points), the lane mask or count
// prefix, camera-z clip, SE(3) pose transform, strict bbox test,
// floor((w - origin) * inv_res) (XLA's form of the division by the
// constant resolution, common.cuh) minus the shard offset, local coord
// validity, dense cell id (INT_MAX where invalid) and the colour
// expansion (f32 channels, packed 0xRRGGBB, or rgb565 x8 x4 x8).  Kernel
// K1 (depth_frontend.cu) does the same job for the depth wire.  The
// world wire (PTS_WORLD, f32 colour) takes the world points a router
// sent to this shard (kernel B12, route_pack.cu): no transform, camera-z
// clip or bbox test, only the local coord window, as the JAX package's
// ``pre_transformed`` frontend (integrate.py:59-95, :259-270).
//
// Bound on the card: memory.  An f32 lane reads 12 B of points, 12 B of
// f32 rgb and 1 B of mask, and writes 28 B (world xyz, id, rgb); a K=8
// batch of 640x480 lanes moves ~130 MB, ~39 us at 3.35 TB/s.  The q16 and
// packed-colour wires read less.  ~30 f32 operations a lane.
//
// Design: one thread per lane over the flat (K*N) lane space, frame-major,
// so neighbouring threads touch neighbouring addresses in every planar
// array; the point wire and the colour wire are template arguments (seven
// instantiations), the mask form a uniform branch.  The pose (16 floats)
// and the (2,3) quantization of a frame are read through the cache.  All
// f32 math uses round-to-nearest intrinsics in the JAX operation order
// (built with -fmad=false): a cell id is a floor, so one contracted
// multiply-add would move a borderline point into another cell.
// Bit-exact against the plain version (ops/integrate.py
// planar_frontend_plain).

#include <limits.h>

#include "common.cuh"

enum { PTS_F32 = 0, PTS_U16 = 1, PTS_WORLD = 2 };
enum { RGB_F32 = 0, RGB_U32 = 1, RGB_565 = 2 };

template <int PW, int RW>
__global__ void planar_frontend_kernel(
    const void* __restrict__ points, const float* __restrict__ quant,
    const void* __restrict__ rgb, const void* __restrict__ mask,
    int mask_is_bool, const float* __restrict__ poses, int K, int N, Geo g,
    float zmin, float zmax, float* __restrict__ world,
    int* __restrict__ ids, float* __restrict__ rgb_out) {
    const long M = (long)K * N;
    long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= M) return;
    const int k = (int)(lane / N);
    const int n = (int)(lane - (long)k * N);
    const long base = 3L * N * k + n;        // channel 0 of (K,3,N)

    float p[3];
    if (PW != PTS_U16) {
        const float* P = (const float*)points;
        for (int a = 0; a < 3; ++a) p[a] = P[base + (long)a * N];
    } else {
        const unsigned short* Q = (const unsigned short*)points;
        const float* qs = quant + 6L * k;
        for (int a = 0; a < 3; ++a)
            p[a] = __fadd_rn(__fmul_rn((float)Q[base + (long)a * N], qs[a]),
                             qs[3 + a]);
    }
    bool valid = mask_is_bool ? ((const unsigned char*)mask)[lane] != 0
                              : n < ((const int*)mask)[k];
    float w[3];
    if (PW == PTS_WORLD) {
        for (int a = 0; a < 3; ++a) w[a] = p[a];
    } else {
        valid = valid && p[2] > zmin && p[2] < zmax;
        pose_transform(poses + 16L * k, p, w);
    }
    int c[3];
    valid = cell_coords_valid(g, w, c, PW != PTS_WORLD) && valid;
    ids[lane] = valid ? (c[0] * g.dims[1] + c[1]) * g.dims[2] + c[2]
                      : INT_MAX;
    world[lane] = w[0];
    world[M + lane] = w[1];
    world[2 * M + lane] = w[2];

    float col[3];
    if (RW == RGB_F32) {
        const float* R = (const float*)rgb;
        for (int a = 0; a < 3; ++a) col[a] = R[base + (long)a * N];
    } else if (RW == RGB_U32) {
        const unsigned v = ((const unsigned*)rgb)[lane];
        col[0] = (float)((v >> 16) & 0xFFu);
        col[1] = (float)((v >> 8) & 0xFFu);
        col[2] = (float)(v & 0xFFu);
    } else {
        expand_565(((const unsigned short*)rgb)[lane], col);
    }
    rgb_out[lane] = col[0];
    rgb_out[M + lane] = col[1];
    rgb_out[2 * M + lane] = col[2];
}

template <int PW, int RW>
static void launch_wires(const void* points, const float* quant,
                         const void* rgb, const void* mask, int mask_is_bool,
                         const float* poses, int K, int N, const Geo& g,
                         float zmin, float zmax, float* world, int* ids,
                         float* rgb_out, cudaStream_t stream) {
    const int threads = 256;
    planar_frontend_kernel<PW, RW>
        <<<grid_blocks((long)K * N, threads), threads, 0, stream>>>(
            points, quant, rgb, mask, mask_is_bool, poses, K, N, g, zmin,
            zmax, world, ids, rgb_out);
}

extern "C" int launch_planar_frontend(
    const void* points, int point_wire, const void* quant, const void* rgb,
    int rgb_wire, const void* mask, int mask_is_bool, const void* poses,
    int K, int N, const float* geo_f, const int* geo_i, float zmin,
    float zmax, void* world, void* ids, void* rgb_out, void* stream) {
    const Geo g = make_geo(geo_f, geo_i);
    const cudaStream_t s = (cudaStream_t)stream;
    const float* q = (const float*)quant;
    const float* P = (const float*)poses;
    float* W = (float*)world;
    int* I = (int*)ids;
    float* C = (float*)rgb_out;
    if (point_wire == PTS_U16 && q == nullptr)
        return (int)cudaErrorInvalidValue;
#define HIFI_WIRES(PW, RW)                                                  \
    launch_wires<PW, RW>(points, q, rgb, mask, mask_is_bool, P, K, N, g,    \
                         zmin, zmax, W, I, C, s)
    switch (point_wire * 3 + rgb_wire) {
        case 0: HIFI_WIRES(PTS_F32, RGB_F32); break;
        case 1: HIFI_WIRES(PTS_F32, RGB_U32); break;
        case 2: HIFI_WIRES(PTS_F32, RGB_565); break;
        case 3: HIFI_WIRES(PTS_U16, RGB_F32); break;
        case 4: HIFI_WIRES(PTS_U16, RGB_U32); break;
        case 5: HIFI_WIRES(PTS_U16, RGB_565); break;
        case 6: HIFI_WIRES(PTS_WORLD, RGB_F32); break;
        default: return (int)cudaErrorInvalidValue;
    }
#undef HIFI_WIRES
    return (int)cudaGetLastError();
}
