// Kernel B12: owner-slab route and pack of a K-frame batch.
//
// Replaces: the XLA compositions route_sort and pack_send of the JAX
// package's routed sharded ingest (hifi_fusion_tpu/parallel/routing.py
// :93 and :143, vmapped over a batch and run on every source device by
// parallel/sharding.py:310-400), and the receive side of its exchange
// (exchange_batch, :175-185).  It computes the same function without
// sorting: per (frame, source s = lane % n, target t) bucket, the lanes in
// the order of JAX's stable sort of concatenate([primary, secondary]) by
// target, each kept lane (rank < Bs) at column s * Bs + rank of
// destination t, written straight into the layout the destinations'
// integrates read:
//   world (n, K, 3, R) f32 and rgb (n, K, 3, R) f32, one buffer of
//   (2, n, K, 3, R) f32, and present (n, K, R) bool, R = n * Bs,
// world and rgb 0 and present false past each bucket's load.  That is
// JAX's send buffer of every source with its destination axis moved to
// the front, so destination j's lanes are the [j] views and the exchange
// between shards of one card copies nothing.
//
// Per lane, the frontend of kernels K1 (depth wire: u16 depth x rays,
// rgb565) or K5 (planar f32 wire: points, f32 rgb, bool mask or count
// prefix) under the GLOBAL geometry (common.cuh, so routed and replicated
// ingests agree bit for bit on survivors), the owner slab by n - 1
// boundary compares and at most one halo secondary target.
//
// Bound on the card: memory.  The wire is read (depth: 4 B a lane and the
// 12 B a pixel ray table; planar: 24-25 B a lane) and K * n * n * Bs
// columns of 25 B written (world and rgb f32, present 1 B), the padding
// included; a K=8 batch of 640x480 depth frames at n=4 and Bs=76,800
// moves ~13.5 MB of wire and ~246 MB of output, ~77 us at 3.35 TB/s.
// The output is nearly all of it, so the design writes every output
// byte exactly once, in wide coalesced stores, and reads the wire twice
// (its arithmetic is cheap and a lane's targets are not kept between the
// passes).
//
// Design: five launches, one copy to the host, and no host wait between
// them, so the card never idles on the host's read.
//  1. count (route_count_kernel): a block per 256 lanes of one source
//     of one frame (source-major blocks: lanes m * n + s, so that a
//     warp's lanes of one bucket take consecutive columns and the pack's
//     stores coalesce); shared-memory histograms of primaries and
//     secondaries by target, a warp-aggregated atomic a (warp, target),
//     written per block as cnt[frame][type][source][target][chunk];
//  2. scan (route_scan_kernel): a block per (frame, type, key) row turns
//     the chunk counts into exclusive offsets and the row's total;
//  3. budget (route_budget_kernel, one block): the largest bucket, the
//     tier (the first covering it, else the top) and the drops, on the
//     card as the JAX package picks its tier (lax.switch), into a
//     3-word budget that one cudaMemcpyAsync copies to a pinned host
//     buffer.  The wrapper allocates the output at the top tier before
//     the count and enqueues the pack and the fill right behind the
//     copy; only then does it wait on the copy's event, and it returns
//     views of the output's first K * n * R columns.  The read stays
//     because the destinations' shapes (R = n * Bs lanes) depend on the
//     tier and eager PyTorch has no shape that waits on the device; it
//     now overlaps the pack and the fill;
//  4. pack (route_pack_kernel): the count pass's blocks again; each lane
//     re-runs the frontend, ranks its primary and its secondary within
//     the block by warp match and per-warp counts in shared memory, adds
//     the chunk offset (and, for a secondary, the bucket's primary
//     total), and writes its six world and rgb words when the rank is
//     under Bs: columns [0, load) of its bucket's rows, load = min(Bs,
//     bucket total);
//  5. fill (route_fill_kernel): a 2-D grid, a row per (destination,
//     frame, channel, source) run of Bs columns (y, 64-bit row base
//     computed once a row, the bucket's load read once a row by one
//     thread) and 4 columns a thread (x, 32-bit in-row indices, the
//     grid sized for the top tier and the blocks past Bs returning at
//     once): float4 zeros from the load (rounded up to 4) to Bs, scalar
//     zeros up to that rounding, and every present byte (column < load)
//     in 4-byte words.  Pack and fill write disjoint bytes that together
//     cover the output once.

#include "common.cuh"

enum { WIRE_DEPTH = 0, WIRE_PLANAR = 1 };
constexpr int RP_THREADS = 256;
constexpr int RP_WARPS = RP_THREADS / 32;
constexpr int RP_MAX_N = 16;
constexpr int RP_MAX_KEYS = RP_MAX_N * RP_MAX_N;
constexpr int RP_MAX_GRID_Y = 65535;
constexpr int RP_MAX_TIERS = 16;

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

// Blocks are source-major: block x of frame y takes source s = x % n
// and that source's lanes nn = m * n + s for m in chunk x / n of 256, so
// a warp's kept lanes of one target take consecutive columns.
template <int WIRE>
__global__ void route_count_kernel(Wire wr, Geo g, Slabs sl,
                                   int* __restrict__ cnt) {
    __shared__ int hist[2][RP_MAX_N];
    const int n = sl.n;
    const int k = blockIdx.y;
    const int s = blockIdx.x % n, chunk = blockIdx.x / n;
    const int nchs = gridDim.x / n;
    const int ln = threadIdx.x & 31;
    if (threadIdx.x < 2 * n) hist[threadIdx.x / n][threadIdx.x % n] = 0;
    __syncthreads();
    const int m = chunk * RP_THREADS + threadIdx.x;
    int tgt[2] = {-1, -1};
    if (m < wr.N / n) {
        float w[3], col[3];
        route_lane<WIRE>(wr, g, sl, k, m * n + s, w, col, &tgt[0], &tgt[1]);
    }
    const unsigned lt = (1u << ln) - 1u;
    for (int t = 0; t < 2; ++t) {
        const unsigned peers = __match_any_sync(0xFFFFFFFFu, tgt[t]);
        if (tgt[t] >= 0 && (peers & lt) == 0)
            atomicAdd(&hist[t][tgt[t]], __popc(peers));
    }
    __syncthreads();
    if (threadIdx.x < 2 * n) {
        const int t = threadIdx.x / n, d = threadIdx.x % n;
        cnt[(((long)k * 2 + t) * n * n + s * n + d) * nchs + chunk] =
            hist[t][d];
    }
}

// a block per row of nchs chunk counts, 4 counts a thread a tile:
// exclusive offsets in place, the row's total to totals[row]
__global__ void route_scan_kernel(int* __restrict__ cnt, int nchs,
                                  int* __restrict__ totals) {
    __shared__ int wsum[RP_WARPS];
    int* r = cnt + (long)blockIdx.x * nchs;
    const int warp = threadIdx.x / 32, ln = threadIdx.x & 31;
    int carry = 0;
    for (int base = 0; base < nchs; base += 4 * RP_THREADS) {
        const int i0 = base + 4 * threadIdx.x;
        int v[4], sum = 0;
        for (int u = 0; u < 4; ++u) {
            v[u] = i0 + u < nchs ? r[i0 + u] : 0;
            sum += v[u];
        }
        int incl = sum;
        for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(0xFFFFFFFFu, incl, o);
            if (ln >= o) incl += t;
        }
        if (ln == 31) wsum[warp] = incl;
        __syncthreads();
        int run = carry + incl - sum, tile = 0;
        for (int w = 0; w < RP_WARPS; ++w) {
            run += w < warp ? wsum[w] : 0;
            tile += wsum[w];
        }
        for (int u = 0; u < 4; ++u) {
            if (i0 + u < nchs) r[i0 + u] = run;
            run += v[u];
        }
        carry += tile;
        __syncthreads();               // wsum is rewritten next tile
    }
    if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

struct Tiers {
    int n;
    int v[RP_MAX_TIERS];
};

// bucket i = (frame, source * n + target): primaries plus secondaries
__device__ __forceinline__ int bucket_total(const int* totals, int i,
                                            int nkey) {
    const int* t = totals + (i / nkey) * 2 * nkey + i % nkey;
    return t[0] + t[nkey];
}

// one block: the largest bucket, the tier (routing.tier_index: the tiers
// below the top that it exceeds) and the lanes past it ->
// budget = {max_bucket, Bs, dropped}
__global__ void route_budget_kernel(const int* __restrict__ totals, int K,
                                    int n, Tiers tiers,
                                    long long* __restrict__ budget) {
    __shared__ long long red[RP_WARPS];
    __shared__ int s_bs;
    const int nkey = n * n, nb = K * nkey;
    const int warp = threadIdx.x / 32, ln = threadIdx.x & 31;
    int mx = 0;
    for (int i = threadIdx.x; i < nb; i += blockDim.x)
        mx = max(mx, bucket_total(totals, i, nkey));
    for (int o = 16; o; o >>= 1)
        mx = max(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, o));
    if (ln == 0) red[warp] = mx;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long m = 0;
        for (int w = 0; w < RP_WARPS; ++w) m = max(m, red[w]);
        int t = 0;
        for (int i = 0; i < tiers.n - 1; ++i) t += m > tiers.v[i];
        budget[0] = m;
        budget[1] = tiers.v[t];
        s_bs = tiers.v[t];
    }
    __syncthreads();
    const int Bs = s_bs;
    long long d = 0;
    for (int i = threadIdx.x; i < nb; i += blockDim.x)
        d += max(bucket_total(totals, i, nkey) - Bs, 0);
    for (int o = 16; o; o >>= 1) d += __shfl_xor_sync(0xFFFFFFFFu, d, o);
    if (ln == 0) red[warp] = d;
    __syncthreads();
    if (threadIdx.x == 0) {
        long long sum = 0;
        for (int w = 0; w < RP_WARPS; ++w) sum += red[w];
        budget[2] = sum;
    }
}

// out: world then rgb, each (n, K, 3, R) f32 with R = n * Bs; the count
// pass's blocks
template <int WIRE>
__global__ void route_pack_kernel(Wire wr, Geo g, Slabs sl,
                                  const int* __restrict__ cnt,
                                  const int* __restrict__ totals,
                                  const long long* __restrict__ budget,
                                  float* __restrict__ out) {
    __shared__ int wcnt[2][RP_WARPS][RP_MAX_N];
    const int Bs = (int)budget[1];
    const int n = sl.n;
    const int nkey = n * n;
    const int k = blockIdx.y;
    const int s = blockIdx.x % n, chunk = blockIdx.x / n;
    const int nchs = gridDim.x / n;
    const int warp = threadIdx.x / 32, ln = threadIdx.x & 31;
    for (int i = threadIdx.x; i < 2 * RP_WARPS * RP_MAX_N; i += blockDim.x)
        (&wcnt[0][0][0])[i] = 0;
    __syncthreads();

    const int m = chunk * RP_THREADS + threadIdx.x;
    float w[3] = {0.f, 0.f, 0.f}, col[3] = {0.f, 0.f, 0.f};
    int tgt[2] = {-1, -1};
    if (m < wr.N / n)
        route_lane<WIRE>(wr, g, sl, k, m * n + s, w, col, &tgt[0], &tgt[1]);
    const unsigned lt = (1u << ln) - 1u;
    int wrank[2];
    for (int t = 0; t < 2; ++t) {
        const unsigned peers = __match_any_sync(0xFFFFFFFFu, tgt[t]);
        wrank[t] = __popc(peers & lt);
        if (tgt[t] >= 0 && (peers & lt) == 0)
            wcnt[t][warp][tgt[t]] = __popc(peers);
    }
    __syncthreads();
    if (threadIdx.x < 2 * n) {         // exclusive scan over the warps
        int* c = &wcnt[threadIdx.x / n][0][threadIdx.x % n];
        int run = 0;
        for (int v = 0; v < RP_WARPS; ++v) {
            const int x = c[v * RP_MAX_N];
            c[v * RP_MAX_N] = run;
            run += x;
        }
    }
    __syncthreads();

    const long R = (long)n * Bs;
    const long plane = (long)n * wr.K * 3 * R;     // world -> rgb
    for (int t = 0; t < 2; ++t) {
        const int dst = tgt[t];
        if (dst < 0) continue;
        const int key = s * n + dst;
        const long row = ((long)k * 2 + t) * nkey + key;
        int rank = cnt[row * nchs + chunk] + wcnt[t][warp][dst] + wrank[t];
        if (t == 1) rank += totals[(long)k * 2 * nkey + key];
        if (rank >= Bs) continue;
        float* o = out + ((long)dst * wr.K + k) * 3 * R + (long)s * Bs
                   + rank;
        o[0] = w[0];
        o[R] = w[1];
        o[2 * R] = w[2];
        o[plane] = col[0];
        o[plane + R] = col[1];
        o[plane + 2 * R] = col[2];
    }
}

// Rows 0 .. rows_f - 1: the (2, n, K, 3, n) runs of Bs f32 of world and
// rgb, zero from the bucket's load to Bs; rows rows_f .. : the (n, K, n)
// runs of Bs present bytes, 1 below the load and 0 from it.  x: 4 columns
// a thread.
__global__ void route_fill_kernel(const int* __restrict__ totals,
                                  const long long* __restrict__ budget,
                                  int K, int n, int rows_f, int rows,
                                  float* __restrict__ out,
                                  unsigned char* __restrict__ present) {
    __shared__ int s_load;
    const int Bs = (int)budget[1];
    const int nkey = n * n;
    const int col = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
    if (4 * blockIdx.x * blockDim.x >= Bs) return;   // past the tier
    const bool vec = (Bs & 3) == 0;    // 16-byte aligned rows
    for (int row = blockIdx.y; row < rows; row += gridDim.y) {
        const bool pres = row >= rows_f;
        const int q = pres ? row - rows_f : row;
        __syncthreads();               // the previous row's s_load read
        if (threadIdx.x == 0) {
            const int s = q % n;
            const int jk = pres ? q / n : (q / (3 * n)) % (n * K);
            const int b = (jk % K) * 2 * nkey + s * n + jk / K;
            s_load = min(totals[b] + totals[b + nkey], Bs);
        }
        __syncthreads();
        const int L = s_load;
        if (col >= Bs || (!pres && col + 4 <= L)) continue;
        const int end = min(col + 4, Bs);
        if (pres) {
            unsigned char* p = present + (long)q * Bs + col;
            if (vec) {
                unsigned v = 0;
                for (int i = 0; i < 4; ++i)
                    v |= (unsigned)(col + i < L) << (8 * i);
                *(unsigned*)p = v;
            } else {
                for (int c = col; c < end; ++c) p[c - col] = c < L;
            }
        } else {
            float* o = out + (long)q * Bs + col;
            if (vec && col >= L) {
                *(float4*)o = make_float4(0.f, 0.f, 0.f, 0.f);
            } else {
                for (int c = max(col, L); c < end; ++c) o[c - col] = 0.f;
            }
        }
    }
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

// count, scan and budget, then the budget to the pinned host buffer
// budget_host (3 int64)
extern "C" int launch_route_count(
    int wire, const void* pts, const void* rgb, const void* mask,
    int mask_is_bool, const void* poses, const void* rays, int K, int N,
    const float* geo_f, const int* geo_i, float zmin, float zmax, int n,
    int slab_w, int halo, void* cnt, void* totals, const int* tiers,
    int ntiers, void* budget, void* budget_host, void* stream) {
    if (n < 1 || n > RP_MAX_N || K < 1 || K > RP_MAX_GRID_Y || N < 1
        || N % n || ntiers < 1 || ntiers > RP_MAX_TIERS)
        return (int)cudaErrorInvalidValue;
    Tiers tt;
    tt.n = ntiers;
    for (int i = 0; i < ntiers; ++i) tt.v[i] = tiers[i];
    const Wire wr = make_wire(pts, rgb, mask, mask_is_bool, poses, rays, K,
                              N, zmin, zmax);
    const Geo g = make_geo(geo_f, geo_i);
    const Slabs sl = {n, slab_w, halo};
    const cudaStream_t st = (cudaStream_t)stream;
    const int nchs = (N / n + RP_THREADS - 1) / RP_THREADS;
    const dim3 grid(n * nchs, K);
    if (wire == WIRE_DEPTH)
        route_count_kernel<WIRE_DEPTH>
            <<<grid, RP_THREADS, 0, st>>>(wr, g, sl, (int*)cnt);
    else
        route_count_kernel<WIRE_PLANAR>
            <<<grid, RP_THREADS, 0, st>>>(wr, g, sl, (int*)cnt);
    route_scan_kernel<<<K * 2 * n * n, RP_THREADS, 0, st>>>(
        (int*)cnt, nchs, (int*)totals);
    route_budget_kernel<<<1, RP_THREADS, 0, st>>>(
        (const int*)totals, K, n, tt, (long long*)budget);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemcpyAsync(budget_host, budget, 3 * sizeof(long long),
                                cudaMemcpyDeviceToHost, st);
}

extern "C" int launch_route_pack(
    int wire, const void* pts, const void* rgb, const void* mask,
    int mask_is_bool, const void* poses, const void* rays, int K, int N,
    const float* geo_f, const int* geo_i, float zmin, float zmax, int n,
    int slab_w, int halo, const void* cnt, const void* totals,
    const void* budget, void* out, void* stream) {
    if (n < 1 || n > RP_MAX_N || K < 1 || K > RP_MAX_GRID_Y || N < 1
        || N % n)
        return (int)cudaErrorInvalidValue;
    const Wire wr = make_wire(pts, rgb, mask, mask_is_bool, poses, rays, K,
                              N, zmin, zmax);
    const Geo g = make_geo(geo_f, geo_i);
    const Slabs sl = {n, slab_w, halo};
    const cudaStream_t st = (cudaStream_t)stream;
    const dim3 grid(n * ((N / n + RP_THREADS - 1) / RP_THREADS), K);
    if (wire == WIRE_DEPTH)
        route_pack_kernel<WIRE_DEPTH><<<grid, RP_THREADS, 0, st>>>(
            wr, g, sl, (const int*)cnt, (const int*)totals,
            (const long long*)budget, (float*)out);
    else
        route_pack_kernel<WIRE_PLANAR><<<grid, RP_THREADS, 0, st>>>(
            wr, g, sl, (const int*)cnt, (const int*)totals,
            (const long long*)budget, (float*)out);
    return (int)cudaGetLastError();
}

// The grid covers the largest tier, Bs_max columns a row; blocks past the
// chosen Bs return at once.  Refuses rows or in-row column indices past
// int (the wrapper raises a ValueError before that).
extern "C" int launch_route_fill(const void* totals, const void* budget,
                                 int K, int n, int Bs_max, void* out,
                                 void* present, void* stream) {
    const long rows_f = 2L * n * K * 3 * n;
    const long rows = rows_f + (long)n * K * n;
    if (n < 1 || n > RP_MAX_N || K < 1 || Bs_max < 1
        || Bs_max > 0x7FFFFFFF - 4 * RP_THREADS || rows > 0x7FFFFFFF)
        return (int)cudaErrorInvalidValue;
    const long groups = ((long)Bs_max + 3) / 4;
    const dim3 grid(grid_blocks(groups, RP_THREADS),
                    (unsigned)(rows < RP_MAX_GRID_Y ? rows : RP_MAX_GRID_Y));
    route_fill_kernel<<<grid, RP_THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)totals, (const long long*)budget, K, n, (int)rows_f,
        (int)rows, (float*)out, (unsigned char*)present);
    return (int)cudaGetLastError();
}
