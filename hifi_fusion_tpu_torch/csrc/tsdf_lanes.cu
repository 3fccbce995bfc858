// Kernels T2 and T2p: the TSDF family's sample lanes of a K-frame batch,
// on the depth wire (T2) and on the planar wire (T2p).
//
// Replaces: the ingest and the sample map of the TSDF family.  T2 fuses
// the depth wire's _unpack_inputs (hifi_fusion_tpu/ops/integrate.py:
// 140-175) with _tsdf_lanes (hifi_fusion_tpu/models/tsdf.py:86-132),
// which the JAX package vmaps over the K frames (tsdf.py:206-210).  T2p
// takes the planar wire of the TSDF step (tsdf.py:351-363): (K,3,N) f32
// camera points, (K,3,N) f32 colour and a (K,) i32 count prefix or a
// (K,N) bool lane mask, and so does the job of the Pallas kernel
// transform_clip_cellid (P1, deleted in d3b2b84; hifi_fusion_tpu/ops/
// pallas_kernels.py:67) fused with the sample map.  Per (frame, point):
// the lane test (count / zero depth, or the mask) and the z clip, the
// SE(3) transform (K1's and K5's order), ray = world - viewpoint, its
// length and unit direction; then per sample s < S at offset
// (s - (S-1)/2) * step: the position, bbox and coord validity, the cell
// id, and the six values [w, w*sdf, cm*r, cm*g, cm*b, cm] (sdf = -offset,
// colour on the middle sample only).  The two wires share the sample
// loop (sample_lanes).
//
// Bit-exact against the plain versions (models/tsdf.py tsdf_lanes_plain,
// tsdf_lanes_planar_plain) and the JAX package on the CPU: XLA contracts
// two expressions of the JAX source into fused multiply-adds, the
// position world + s*dirn and the squared length x*x + y*y + z*z
// (fma(z, z, fma(y, y, x*x))), so they are __fmaf_rn here; everything
// else is separately rounded (-fmad=false).  XLA also turns the products
// with the 0/1 weight into selects, so an invalid lane holds +0.0 in
// every channel.
//
// Bound on the card: memory writes.  A point writes S x 28 B (an i32 key
// and six f32 values) and reads 4 B of depth wire and 12 B of rays (T2)
// or 24-25 B of planar wire (T2p): at the config-5 batch (K=8, S=11,
// 640x480) 27.0 M lanes, ~757 MB written, ~0.23-0.24 ms at 3.35 TB/s.
// The arithmetic (~25 flops a sample) is far below the card's rate.
//
// Design: one thread per (frame, point), frame-major; the thread writes
// its S lanes at k*S*N + s*N + n, so for each s neighbouring threads write
// neighbouring addresses of every output plane, and read neighbouring
// addresses of every input plane.

#include <limits.h>

#include "common.cuh"

// the S sample lanes of camera point p (already transformed to world
// point w by pose P of frame k; ok = the lane test and the z clip)
__device__ __forceinline__ void sample_lanes(
    const float* w, const float* P, bool ok, const float* rgb, int k,
    int n, int N, int S, long M, float step, float half, const Geo& g,
    int* __restrict__ skey, float* __restrict__ vals) {
    float ray[3];
    for (int a = 0; a < 3; ++a) ray[a] = __fsub_rn(w[a], P[4 * a + 3]);
    const float dist = __fsqrt_rn(__fmaf_rn(
        ray[2], ray[2], __fmaf_rn(ray[1], ray[1], __fmul_rn(ray[0], ray[0]))));
    const float den = fmaxf(dist, 1e-6f);
    const float dirn[3] = {__fdiv_rn(ray[0], den), __fdiv_rn(ray[1], den),
                           __fdiv_rn(ray[2], den)};
    for (int s = 0; s < S; ++s) {
        const float off = __fmul_rn(__fsub_rn((float)s, half), step);
        bool valid = ok;
        int c[3];
        for (int a = 0; a < 3; ++a) {
            const float pos = __fmaf_rn(off, dirn[a], w[a]);
            valid = valid && pos > g.lo[a] && pos < g.hi[a];
            c[a] = (int)floorf(
                __fmul_rn(__fsub_rn(pos, g.origin[a]), g.inv_res[a]));
            valid = valid && c[a] >= 0 && c[a] < g.dims[a];
        }
        const bool mid = valid && s == S / 2;
        const long o = (long)k * S * N + (long)s * N + n;
        skey[o] = valid ? (c[0] * g.dims[1] + c[1]) * g.dims[2] + c[2]
                        : INT_MAX;
        vals[o] = valid ? 1.0f : 0.0f;
        vals[M + o] = valid ? -off : 0.0f;
        vals[2 * M + o] = mid ? rgb[0] : 0.0f;
        vals[3 * M + o] = mid ? rgb[1] : 0.0f;
        vals[4 * M + o] = mid ? rgb[2] : 0.0f;
        vals[5 * M + o] = mid ? 1.0f : 0.0f;
    }
}

__global__ void tsdf_lanes_kernel(
    const unsigned short* __restrict__ depth,
    const unsigned short* __restrict__ rgb565,
    const int* __restrict__ counts, const float* __restrict__ poses,
    const float* __restrict__ rays, int K, int N, int S, float step,
    float half, Geo g, float zmin, float zmax, int* __restrict__ skey,
    float* __restrict__ vals) {
    const long KN = (long)K * N;
    const long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= KN) return;
    const int k = (int)(lane / N);
    const int n = (int)(lane - (long)k * N);

    const unsigned short dq = depth[lane];
    const float d = (float)dq;
    const float p[3] = {__fmul_rn(d, rays[n]), __fmul_rn(d, rays[N + n]),
                        __fmul_rn(d, rays[2L * N + n])};
    const float* P = poses + 16L * k;
    float w[3];
    pose_transform(P, p, w);
    const bool ok = n < counts[k] && dq > 0 && p[2] > zmin && p[2] < zmax;
    const unsigned v = rgb565[lane];
    const float rgb[3] = {(float)((v >> 11) & 0x1Fu) * 8.0f,
                          (float)((v >> 5) & 0x3Fu) * 4.0f,
                          (float)(v & 0x1Fu) * 8.0f};
    sample_lanes(w, P, ok, rgb, k, n, N, S, KN * S, step, half, g, skey,
                 vals);
}

template <bool MASK_IS_BOOL>
__global__ void tsdf_lanes_planar_kernel(
    const float* __restrict__ points, const float* __restrict__ rgb,
    const void* __restrict__ mask, const float* __restrict__ poses, int K,
    int N, int S, float step, float half, Geo g, float zmin, float zmax,
    int* __restrict__ skey, float* __restrict__ vals) {
    const long KN = (long)K * N;
    const long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= KN) return;
    const int k = (int)(lane / N);
    const int n = (int)(lane - (long)k * N);
    const long base = 3L * N * k + n;        // channel 0 of (K,3,N)

    const float p[3] = {points[base], points[base + N],
                        points[base + 2L * N]};
    const bool in = MASK_IS_BOOL ? ((const unsigned char*)mask)[lane] != 0
                                 : n < ((const int*)mask)[k];
    const bool ok = in && p[2] > zmin && p[2] < zmax;
    const float* P = poses + 16L * k;
    float w[3];
    pose_transform(P, p, w);
    const float col[3] = {rgb[base], rgb[base + N], rgb[base + 2L * N]};
    sample_lanes(w, P, ok, col, k, n, N, S, KN * S, step, half, g, skey,
                 vals);
}

extern "C" int launch_tsdf_lanes(
    const void* depth, const void* rgb565, const void* counts,
    const void* poses, const void* rays, int K, int N, int S, float step,
    float half, const float* geo_f, const int* geo_i, float zmin,
    float zmax, void* skey, void* vals, void* stream) {
    const long KN = (long)K * N;
    if (KN == 0 || S == 0) return 0;
    const int threads = 256;
    tsdf_lanes_kernel<<<grid_blocks(KN, threads), threads, 0,
                        (cudaStream_t)stream>>>(
        (const unsigned short*)depth, (const unsigned short*)rgb565,
        (const int*)counts, (const float*)poses, (const float*)rays, K, N, S,
        step, half, make_geo(geo_f, geo_i), zmin, zmax, (int*)skey,
        (float*)vals);
    return (int)cudaGetLastError();
}

extern "C" int launch_tsdf_lanes_planar(
    const void* points, const void* rgb, const void* mask, int mask_is_bool,
    const void* poses, int K, int N, int S, float step, float half,
    const float* geo_f, const int* geo_i, float zmin, float zmax,
    void* skey, void* vals, void* stream) {
    const long KN = (long)K * N;
    if (KN == 0 || S == 0) return 0;
    const int threads = 256;
    const Geo g = make_geo(geo_f, geo_i);
    const cudaStream_t st = (cudaStream_t)stream;
    if (mask_is_bool)
        tsdf_lanes_planar_kernel<true><<<grid_blocks(KN, threads), threads,
                                         0, st>>>(
            (const float*)points, (const float*)rgb, mask,
            (const float*)poses, K, N, S, step, half, g, zmin, zmax,
            (int*)skey, (float*)vals);
    else
        tsdf_lanes_planar_kernel<false><<<grid_blocks(KN, threads), threads,
                                          0, st>>>(
            (const float*)points, (const float*)rgb, mask,
            (const float*)poses, K, N, S, step, half, g, zmin, zmax,
            (int*)skey, (float*)vals);
    return (int)cudaGetLastError();
}
