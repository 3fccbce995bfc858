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
// ``pre_transformed`` frontend (integrate.py:59-95, :259-270).  The
// record wire (record_frontend_kernel, at the end) reads PointCloud2
// records as they arrived and decodes them in the lane.
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

// The record wire: K5 on PointCloud2 records as they arrived, so the host
// neither decodes nor repacks a cloud (the session's fusion path).  Row k
// of ``rec`` (``row_bytes`` bytes) holds frame k's records; row k of the
// (K,6) i32 ``table`` its count, point_step and the byte offsets of x, y,
// z and the packed 0x00RRGGBB word (-1: no colour).  Per lane: the four
// 32-bit fields read from the record (one 16-byte load when the fields
// share an aligned 16-byte window, the cell's 16-byte layout; word loads
// when everything is 4-aligned; else byte by byte), the colour expanded
// as RGB_U32 with blue shifted by ``blue_shift`` (1: the reference's bug),
// then the f32 path above with the count prefix.  Lanes at or past the
// count, or whose fields would lie outside the row, load nothing and take
// zeros, as the planar wire's padding: every output word equals that of
// the host decode followed by the RGB_F32 wire (ops/integrate.py
// record_frontend_plain).  The caller validates the table
// (runtime/decode.record_fields).  Bound: memory, a lane's count of
// record bytes in (16 in the cell) and 28 B out.

// one little-endian 32-bit field at byte ``off`` of the record ``r``
__device__ __forceinline__ unsigned record_word(const unsigned char* r,
                                                int off, bool words) {
    if (words) return __ldg((const unsigned*)(r + off));
    return (unsigned)__ldg(r + off) | ((unsigned)__ldg(r + off + 1) << 8) |
           ((unsigned)__ldg(r + off + 2) << 16) |
           ((unsigned)__ldg(r + off + 3) << 24);
}

__device__ __forceinline__ unsigned pick_word(const uint4& q, int i) {
    return i == 0 ? q.x : i == 1 ? q.y : i == 2 ? q.z : q.w;
}

__global__ void record_frontend_kernel(
    const unsigned char* __restrict__ rec, long row_bytes,
    const int* __restrict__ table, int blue_shift,
    const float* __restrict__ poses, int K, int N, Geo g, float zmin,
    float zmax, float* __restrict__ world, int* __restrict__ ids,
    float* __restrict__ rgb_out) {
    const long M = (long)K * N;
    long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= M) return;
    const int k = (int)(lane / N);
    const int n = (int)(lane - (long)k * N);
    const int* t = table + 6L * k;
    const int count = __ldg(t), step = __ldg(t + 1);
    const int off[4] = {__ldg(t + 2), __ldg(t + 3), __ldg(t + 4),
                        __ldg(t + 5)};
    const bool has_rgb = off[3] >= 0;
    const int o3 = has_rgb ? off[3] : off[0];
    const int lo = min(min(off[0], off[1]), min(off[2], o3));
    const int hi = max(max(off[0], off[1]), max(off[2], o3));
    // whatever the table holds, no read leaves the frame's row
    const bool live = n < count && step > 0 && lo >= 0 &&
                      (long)n * step + hi + 4 <= row_bytes;

    float p[3] = {0.0f, 0.0f, 0.0f};
    unsigned v = 0u;
    if (live) {
        const unsigned char* frame = rec + (long)k * row_bytes;
        const unsigned char* r = frame + (long)n * step;
        const bool words =
            (((size_t)frame | (size_t)step | (size_t)off[0] |
              (size_t)off[1] | (size_t)off[2] | (size_t)o3) & 3) == 0;
        unsigned w[4];
        if (words && (((size_t)frame | (size_t)step) & 15) == 0 &&
            (lo & ~15) == (hi & ~15)) {
            const int base = lo & ~15;
            const uint4 q = __ldg((const uint4*)(r + base));
            for (int a = 0; a < 4; ++a)
                w[a] = pick_word(q, ((a == 3 ? o3 : off[a]) - base) >> 2);
        } else {
            for (int a = 0; a < 4; ++a)
                w[a] = record_word(r, a == 3 ? o3 : off[a], words);
        }
        for (int a = 0; a < 3; ++a) p[a] = __uint_as_float(w[a]);
        if (has_rgb) v = w[3];
    }
    bool valid = live && p[2] > zmin && p[2] < zmax;
    float wp[3];
    pose_transform(poses + 16L * k, p, wp);
    int c[3];
    valid = cell_coords_valid(g, wp, c, true) && valid;
    ids[lane] = valid ? (c[0] * g.dims[1] + c[1]) * g.dims[2] + c[2]
                      : INT_MAX;
    world[lane] = wp[0];
    world[M + lane] = wp[1];
    world[2 * M + lane] = wp[2];
    rgb_out[lane] = (float)((v >> 16) & 0xFFu);
    rgb_out[M + lane] = (float)((v >> 8) & 0xFFu);
    rgb_out[2 * M + lane] = (float)((v >> blue_shift) & 0xFFu);
}

extern "C" int launch_record_frontend(
    const void* rec, long row_bytes, const void* table, int blue_shift,
    const void* poses, int K, int N, const float* geo_f, const int* geo_i,
    float zmin, float zmax, void* world, void* ids, void* rgb_out,
    void* stream) {
    const int threads = 256;
    record_frontend_kernel<<<grid_blocks((long)K * N, threads), threads, 0,
                             (cudaStream_t)stream>>>(
        (const unsigned char*)rec, row_bytes, (const int*)table, blue_shift,
        (const float*)poses, K, N, make_geo(geo_f, geo_i), zmin, zmax,
        (float*)world, (int*)ids, (float*)rgb_out);
    return (int)cudaGetLastError();
}
