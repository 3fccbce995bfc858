// Kernel B12: owner-slab route and pack of a K-frame batch.
//
// Replaces: the XLA compositions route_sort and pack_send of the JAX
// package's routed sharded ingest (hifi_fusion_tpu/parallel/routing.py
// :93 and :143, vmapped over a batch and run on every source device by
// parallel/sharding.py:310-400).  It computes the same function without
// sorting: per (frame, source s = lane % n, target t) bucket, the lanes in
// the order of JAX's stable sort of concatenate([primary, secondary]) by
// target, packed into send[frame, s, :, t * Bs + rank] as
// [wx wy wz r g b 1] when rank < Bs, the rest zero.
//
// Per lane, the frontend of kernels K1 (depth wire: u16 depth x rays,
// rgb565) or K5 (planar f32 wire: points, f32 rgb, bool mask or count
// prefix) under the GLOBAL geometry (common.cuh, so routed and replicated
// ingests agree bit for bit on survivors), the owner slab by n - 1
// boundary compares and at most one halo secondary target.
//
// Bound on the card: memory.  The wire is read (depth: 4 B a lane and the
// 12 B a pixel ray table; planar: 24-25 B a lane) and the send buffer of
// K * n * 7 * n * Bs f32 written, its padding included; a K=8 batch of
// 640x480 depth frames at n=4 and Bs=38,400 moves ~10 MB of wire and
// ~138 MB of send buffer, ~44 us at 3.35 TB/s.
//
// Design: three passes and one host read.
//  1. count (route_count_kernel): a block per 256 lanes of one frame;
//     shared-memory histograms of primaries and secondaries by (source,
//     target) key, written per block as cnt[frame][type][key][block];
//  2. scan (route_scan_kernel): a warp per (frame, type, key) row turns
//     the block counts into exclusive block offsets and row totals;
//     the wrapper reads the totals (K * 2 * n^2 ints), picks the tier
//     and counts the drops;
//  3. pack (route_pack_kernel): the count pass's blocks again; each lane
//     re-runs the frontend, ranks its primary and its secondary within
//     the block by warp match and per-warp counts in shared memory, adds
//     the block offset (and, for a secondary, the bucket's primary
//     total), and writes its 7 channels when the rank is under Bs; a
//     pad pass (route_pad_kernel) zeroes every column at or past its
//     bucket's load.
// The wire is read twice (count and pack): the arithmetic is cheap and a
// lane's targets are not kept between the passes.

#include "common.cuh"

enum { WIRE_DEPTH = 0, WIRE_PLANAR = 1 };
constexpr int RP_THREADS = 256;
constexpr int RP_WARPS = RP_THREADS / 32;
constexpr int RP_MAX_N = 16;
constexpr int RP_MAX_KEYS = RP_MAX_N * RP_MAX_N;

struct Wire {
    const void* pts;     // depth (K,N) u16 | points (K,3,N) f32
    const void* rgb;     // rgb565 (K,N) u16 | rgb (K,3,N) f32
    const void* mask;    // counts (K,) i32 | mask (K,N) bool or (K,) i32
    int mask_is_bool;
    const float* poses;  // (K,4,4)
    const float* rays;   // (3,N) for the depth wire
    int K, N;
    float zmin, zmax;
};

struct Slabs {
    int n, slab_w, halo;
};

// the frontend of lane nn of frame k: world point, colour and targets
// (primary and secondary shard, -1 where none)
template <int WIRE>
__device__ __forceinline__ void route_lane(const Wire& wr, const Geo& g,
                                           const Slabs& sl, int k, int nn,
                                           float* w, float* col, int* prim,
                                           int* sec) {
    const long lane = (long)k * wr.N + nn;
    float p[3];
    bool valid;
    if (WIRE == WIRE_DEPTH) {
        const unsigned short dq = ((const unsigned short*)wr.pts)[lane];
        const float d = (float)dq;
        for (int a = 0; a < 3; ++a)
            p[a] = __fmul_rn(d, wr.rays[(long)a * wr.N + nn]);
        valid = nn < ((const int*)wr.mask)[k] && dq > 0;
        expand_565(((const unsigned short*)wr.rgb)[lane], col);
    } else {
        const long base = 3L * wr.N * k + nn;
        const float* P = (const float*)wr.pts;
        const float* R = (const float*)wr.rgb;
        for (int a = 0; a < 3; ++a) {
            p[a] = P[base + (long)a * wr.N];
            col[a] = R[base + (long)a * wr.N];
        }
        valid = wr.mask_is_bool ? ((const unsigned char*)wr.mask)[lane] != 0
                                : nn < ((const int*)wr.mask)[k];
    }
    valid = valid && p[2] > wr.zmin && p[2] < wr.zmax;
    pose_transform(wr.poses + 16L * k, p, w);
    int c[3];
    valid = cell_coords_valid(g, w, c, true) && valid;
    int owner = 0;
    for (int j = 1; j < sl.n; ++j) owner += c[0] >= j * sl.slab_w;
    const int local = c[0] - owner * sl.slab_w;
    const int s2 = local < sl.halo ? owner - 1
                   : local >= sl.slab_w - sl.halo ? owner + 1 : -1;
    *prim = valid ? owner : -1;
    *sec = valid && s2 >= 0 && s2 < sl.n ? s2 : -1;
}

template <int WIRE>
__global__ void route_count_kernel(Wire wr, Geo g, Slabs sl,
                                   int* __restrict__ cnt) {
    __shared__ int hist[2][RP_MAX_KEYS];
    const int nkey = sl.n * sl.n;
    const int k = blockIdx.y;
    const int nch = gridDim.x;
    for (int i = threadIdx.x; i < 2 * nkey; i += blockDim.x)
        hist[i / nkey][i % nkey] = 0;
    __syncthreads();
    const int nn = blockIdx.x * RP_THREADS + threadIdx.x;
    if (nn < wr.N) {
        float w[3], col[3];
        int prim, sec;
        route_lane<WIRE>(wr, g, sl, k, nn, w, col, &prim, &sec);
        const int s = nn % sl.n;
        if (prim >= 0) atomicAdd(&hist[0][s * sl.n + prim], 1);
        if (sec >= 0) atomicAdd(&hist[1][s * sl.n + sec], 1);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * nkey; i += blockDim.x)
        cnt[((long)k * 2 * nkey + i) * nch + blockIdx.x] =
            hist[i / nkey][i % nkey];
}

// a warp per row of nch block counts: exclusive offsets in place, the
// row's total to totals[row]
__global__ void route_scan_kernel(int* __restrict__ cnt, int rows, int nch,
                                  int* __restrict__ totals) {
    const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
    const int ln = threadIdx.x & 31;
    if (row >= rows) return;
    int* r = cnt + (long)row * nch;
    int carry = 0;
    for (int b = 0; b < nch; b += 32) {
        const int i = b + ln;
        const int v = i < nch ? r[i] : 0;
        int incl = v;
        for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(0xFFFFFFFFu, incl, o);
            if (ln >= o) incl += t;
        }
        if (i < nch) r[i] = carry + incl - v;
        carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
    }
    if (ln == 0) totals[row] = carry;
}

template <int WIRE>
__global__ void route_pack_kernel(Wire wr, Geo g, Slabs sl,
                                  const int* __restrict__ cnt,
                                  const int* __restrict__ totals, int Bs,
                                  float* __restrict__ send) {
    __shared__ int wcnt[2][RP_WARPS][RP_MAX_KEYS];
    const int n = sl.n;
    const int nkey = n * n;
    const int k = blockIdx.y;
    const int nch = gridDim.x;
    const int warp = threadIdx.x / 32, ln = threadIdx.x & 31;
    for (int i = threadIdx.x; i < 2 * RP_WARPS * nkey; i += blockDim.x)
        wcnt[i / (RP_WARPS * nkey)][(i / nkey) % RP_WARPS][i % nkey] = 0;
    __syncthreads();

    const int nn = blockIdx.x * RP_THREADS + threadIdx.x;
    float w[3] = {0.f, 0.f, 0.f}, col[3] = {0.f, 0.f, 0.f};
    int prim = -1, sec = -1;
    if (nn < wr.N) route_lane<WIRE>(wr, g, sl, k, nn, w, col, &prim, &sec);
    const int s = nn % n;
    const int key[2] = {prim >= 0 ? s * n + prim : -1,
                        sec >= 0 ? s * n + sec : -1};
    const unsigned lt = (1u << ln) - 1u;
    int wrank[2];
    for (int t = 0; t < 2; ++t) {
        const unsigned peers = __match_any_sync(0xFFFFFFFFu, key[t]);
        wrank[t] = __popc(peers & lt);
        if (key[t] >= 0 && (peers & lt) == 0)
            wcnt[t][warp][key[t]] = __popc(peers);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 2 * nkey; i += blockDim.x) {
        int* c = &wcnt[i / nkey][0][i % nkey];
        int run = 0;
        for (int v = 0; v < RP_WARPS; ++v) {
            const int x = c[v * RP_MAX_KEYS];
            c[v * RP_MAX_KEYS] = run;
            run += x;
        }
    }
    __syncthreads();

    const long R = (long)n * Bs;
    for (int t = 0; t < 2; ++t) {
        if (key[t] < 0) continue;
        const long row = ((long)k * 2 + t) * nkey + key[t];
        int rank = cnt[row * nch + blockIdx.x] + wcnt[t][warp][key[t]]
                   + wrank[t];
        if (t == 1) rank += totals[(long)k * 2 * nkey + key[t]];
        if (rank >= Bs) continue;
        const int dst = t == 0 ? prim : sec;
        float* out = send + ((long)k * n + s) * 7 * R + (long)dst * Bs + rank;
        out[0] = w[0];
        out[R] = w[1];
        out[2 * R] = w[2];
        out[3 * R] = col[0];
        out[4 * R] = col[1];
        out[5 * R] = col[2];
        out[6 * R] = 1.0f;
    }
}

// zero every send column at or past its bucket's load
__global__ void route_pad_kernel(const int* __restrict__ totals, int K,
                                 int n, int Bs, float* __restrict__ send) {
    const long total = (long)K * n * 7 * n * Bs;
    const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int r = (int)(idx % Bs);
    const long q = idx / Bs;
    const int t = (int)(q % n);
    const long row = q / n;                    // (k * n + s) * 7 + channel
    const long ks = row / 7;
    const int s = (int)(ks % n), k = (int)(ks / n);
    const int nkey = n * n;
    const long b = (long)k * 2 * nkey + s * n + t;
    if (r >= totals[b] + totals[b + nkey]) send[idx] = 0.0f;
}

static Wire make_wire(const void* pts, const void* rgb, const void* mask,
                      int mask_is_bool, const void* poses, const void* rays,
                      int K, int N, float zmin, float zmax) {
    Wire wr;
    wr.pts = pts;
    wr.rgb = rgb;
    wr.mask = mask;
    wr.mask_is_bool = mask_is_bool;
    wr.poses = (const float*)poses;
    wr.rays = (const float*)rays;
    wr.K = K;
    wr.N = N;
    wr.zmin = zmin;
    wr.zmax = zmax;
    return wr;
}

extern "C" int launch_route_count(
    int wire, const void* pts, const void* rgb, const void* mask,
    int mask_is_bool, const void* poses, const void* rays, int K, int N,
    const float* geo_f, const int* geo_i, float zmin, float zmax, int n,
    int slab_w, int halo, void* cnt, void* totals, void* stream) {
    if (n < 1 || n > RP_MAX_N || K < 1 || N < 1)
        return (int)cudaErrorInvalidValue;
    const Wire wr = make_wire(pts, rgb, mask, mask_is_bool, poses, rays, K,
                              N, zmin, zmax);
    const Geo g = make_geo(geo_f, geo_i);
    const Slabs sl = {n, slab_w, halo};
    const cudaStream_t st = (cudaStream_t)stream;
    const int nch = (N + RP_THREADS - 1) / RP_THREADS;
    const dim3 grid(nch, K);
    if (wire == WIRE_DEPTH)
        route_count_kernel<WIRE_DEPTH>
            <<<grid, RP_THREADS, 0, st>>>(wr, g, sl, (int*)cnt);
    else
        route_count_kernel<WIRE_PLANAR>
            <<<grid, RP_THREADS, 0, st>>>(wr, g, sl, (int*)cnt);
    const int rows = K * 2 * n * n;
    route_scan_kernel<<<grid_blocks((long)rows * 32, 256), 256, 0, st>>>(
        (int*)cnt, rows, nch, (int*)totals);
    return (int)cudaGetLastError();
}

extern "C" int launch_route_pack(
    int wire, const void* pts, const void* rgb, const void* mask,
    int mask_is_bool, const void* poses, const void* rays, int K, int N,
    const float* geo_f, const int* geo_i, float zmin, float zmax, int n,
    int slab_w, int halo, const void* cnt, const void* totals, int Bs,
    void* send, void* stream) {
    if (n < 1 || n > RP_MAX_N || K < 1 || N < 1 || Bs < 1)
        return (int)cudaErrorInvalidValue;
    const Wire wr = make_wire(pts, rgb, mask, mask_is_bool, poses, rays, K,
                              N, zmin, zmax);
    const Geo g = make_geo(geo_f, geo_i);
    const Slabs sl = {n, slab_w, halo};
    const cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid((N + RP_THREADS - 1) / RP_THREADS, K);
    if (wire == WIRE_DEPTH)
        route_pack_kernel<WIRE_DEPTH><<<grid, RP_THREADS, 0, st>>>(
            wr, g, sl, (const int*)cnt, (const int*)totals, Bs,
            (float*)send);
    else
        route_pack_kernel<WIRE_PLANAR><<<grid, RP_THREADS, 0, st>>>(
            wr, g, sl, (const int*)cnt, (const int*)totals, Bs,
            (float*)send);
    const long total = (long)K * n * 7 * n * Bs;
    route_pad_kernel<<<grid_blocks(total, 256), 256, 0, st>>>(
        (const int*)totals, K, n, Bs, (float*)send);
    return (int)cudaGetLastError();
}
