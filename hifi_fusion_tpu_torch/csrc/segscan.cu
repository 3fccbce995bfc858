// Kernel T1: the two-level blocked segmented scan (add / first / or).
//
// Replaces: the Pallas kernel block_segscan (P2, deleted in d3b2b84;
// hifi_fusion_tpu/ops/pallas_segscan.py:74), the in-block phase of
// segment_reduce (hifi_fusion_tpu/ops/scatter.py:167-235), and the rest of
// segment_reduce with it.  Semantics, step for step as the JAX package's
// ladder (scatter.py:187-235):
//   1. per 512-lane block (the array zero-padded to whole blocks), the
//      9-step Hillis-Steele ladder v[i] = f[i] ? v[i] : op(v[i-s], v[i]),
//      f[i] |= f[i-s], where a lane with no left neighbour at distance s
//      inside its block combines with ZERO;
//   2. the same ladder over the nb block summaries (each block's last lane
//      and its flag-OR);
//   3. the combine: out = ff ? vv : op(ev, vv), with ff the in-block flag
//      prefix and ev the exclusive block prefix (zero for block 0).
// For n <= 1024 the whole array is one flat ladder.  Keeping this exact
// association order makes the f32 sums bit-identical to the JAX package's
// and to the plain version (ops/scatter.py segment_reduce_plain), so
// |tsdf| gates downstream decide identically.  Zero is combined literally
// (0 + -0.0 = +0.0), as XLA computes it.
//
// Kinds: 0 "add" (f32, round-to-nearest adds), 1 "first" (any 32-bit
// word: the left operand), 2 "or" (32-bit words).  Values are (k, n)
// 32-bit words, flags (n,) bytes.
//
// Bound on the card: memory.  On the TSDF path (k=6, 27 M lanes) phase 1
// reads 6 x 4 B + 1 B a lane and writes 6 x 4 B: ~1.3 GB, ~0.4 ms at
// 3.35 TB/s; phase 3 re-reads and rewrites the lanes whose block holds no
// flag before them (few, on the TSDF path, where segments are short).
// The ladder's shared-memory traffic and barriers (9 steps x 2 per
// channel) are the likely limit of this simple form.
//
// Design: phase 1, one CTA of 512 threads per block; the flag ladder runs
// once and each thread keeps its flag before every step as one bit of a
// mask; the value ladder then runs per channel through shared memory.
// Phase 2, one CTA walks the nb summaries (nb <= 2^22) with ping-pong
// buffers in device memory, flags first (as bit masks), then per channel.
// Phase 3, one thread per lane.

#include "common.cuh"

#define SEG_BS 512

template <int KIND>
__device__ __forceinline__ uint32_t seg_op(uint32_t left, uint32_t here) {
    if (KIND == 0)
        return __float_as_uint(
            __fadd_rn(__uint_as_float(left), __uint_as_float(here)));
    if (KIND == 2) return left | here;
    return left;
}

// One ladder over blockDim.x lanes per CTA.  With summ != nullptr also
// writes each channel's last lane to summ[c*nb + block] and the block's
// first flagged lane (blockDim.x if none) to first[block].
template <int KIND>
__global__ void segscan_block_kernel(const uint32_t* __restrict__ vals,
                                     const unsigned char* __restrict__ starts,
                                     int k, long n, uint32_t* __restrict__ out,
                                     uint32_t* __restrict__ summ, int nb,
                                     int* __restrict__ first) {
    __shared__ uint32_t sv[1024];
    __shared__ unsigned char sf[1024];
    __shared__ int sfirst;
    const int t = threadIdx.x;
    const int width = blockDim.x;
    const long lane = (long)blockIdx.x * width + t;
    const bool live = lane < n;

    bool f = live && starts[lane] != 0;
    if (t == 0) sfirst = width;
    __syncthreads();
    if (f) atomicMin(&sfirst, t);
    // bit j of fmask: this lane's flag before ladder step j
    uint32_t fmask = 0;
    int j = 0;
    for (int s = 1; s < width; s <<= 1, ++j) {
        sf[t] = f;
        __syncthreads();
        const bool fs = t >= s && sf[t - s] != 0;
        __syncthreads();
        if (f) fmask |= 1u << j;
        f = f || fs;
    }
    for (int c = 0; c < k; ++c) {
        uint32_t v = live ? vals[(long)c * n + lane] : 0u;
        j = 0;
        for (int s = 1; s < width; s <<= 1, ++j) {
            sv[t] = v;
            __syncthreads();
            const uint32_t vs = t >= s ? sv[t - s] : 0u;
            __syncthreads();
            if (!((fmask >> j) & 1u)) v = seg_op<KIND>(vs, v);
        }
        if (live) out[(long)c * n + lane] = v;
        if (summ != nullptr && t == width - 1)
            summ[(long)c * nb + blockIdx.x] = v;
    }
    __syncthreads();
    if (first != nullptr && t == 0) first[blockIdx.x] = sfirst;
}

// The ladder over the nb block summaries, one CTA.  summ is (2, k, nb):
// row c of the first half holds the summaries on entry and the inclusive
// scan on exit; the second half is the ping-pong partner.  aux is (4, nb):
// first, flag masks, and two flag ping-pong rows.
template <int KIND>
__global__ void segscan_summary_kernel(uint32_t* __restrict__ summ, int k,
                                       int nb, int* __restrict__ aux) {
    const int t = threadIdx.x;
    const int T = blockDim.x;
    const int* first = aux;
    uint32_t* fbits = (uint32_t*)(aux + nb);
    int* fa = aux + 2 * nb;
    int* fb = aux + 3 * nb;
    for (int b = t; b < nb; b += T) {
        fa[b] = first[b] < SEG_BS;
        fbits[b] = 0u;
    }
    __syncthreads();
    int j = 0;
    for (int s = 1; s < nb; s <<= 1, ++j) {
        for (int b = t; b < nb; b += T) {
            const int f = fa[b];
            if (f) fbits[b] |= 1u << j;
            fb[b] = f | (b >= s ? fa[b - s] : 0);
        }
        __syncthreads();
        int* tmp = fa; fa = fb; fb = tmp;
    }
    for (int c = 0; c < k; ++c) {
        uint32_t* home = summ + (long)c * nb;
        uint32_t* a = home;
        uint32_t* o = summ + (long)(k + c) * nb;
        j = 0;
        for (int s = 1; s < nb; s <<= 1, ++j) {
            for (int b = t; b < nb; b += T) {
                uint32_t v = a[b];
                if (!((fbits[b] >> j) & 1u))
                    v = seg_op<KIND>(b >= s ? a[b - s] : 0u, v);
                o[b] = v;
            }
            __syncthreads();
            uint32_t* tmp = a; a = o; o = tmp;
        }
        if (a != home) {
            for (int b = t; b < nb; b += T) home[b] = a[b];
            __syncthreads();
        }
    }
}

// out = ff ? vv : op(ev, vv), one thread per lane, every channel.
template <int KIND>
__global__ void segscan_combine_kernel(uint32_t* __restrict__ out, int k,
                                       long n,
                                       const uint32_t* __restrict__ summ,
                                       int nb, const int* __restrict__ first) {
    const long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= n) return;
    const int b = (int)(lane / SEG_BS);
    const int t = (int)(lane - (long)b * SEG_BS);
    if (t >= first[b]) return;              // a flag at or before the lane
    for (int c = 0; c < k; ++c) {
        const uint32_t ev = b > 0 ? summ[(long)c * nb + b - 1] : 0u;
        const long i = (long)c * n + lane;
        out[i] = seg_op<KIND>(ev, out[i]);
    }
}

template <int KIND>
static int run_segscan(const uint32_t* vals, const unsigned char* starts,
                       int k, long n, uint32_t* out, uint32_t* summ, int* aux,
                       cudaStream_t st) {
    if (n <= 2 * SEG_BS) {
        segscan_block_kernel<KIND><<<1, (int)n, 0, st>>>(
            vals, starts, k, n, out, nullptr, 1, nullptr);
        return (int)cudaGetLastError();
    }
    const int nb = (int)((n + SEG_BS - 1) / SEG_BS);
    segscan_block_kernel<KIND><<<nb, SEG_BS, 0, st>>>(vals, starts, k, n,
                                                      out, summ, nb, aux);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    segscan_summary_kernel<KIND><<<1, 1024, 0, st>>>(summ, k, nb, aux);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
    segscan_combine_kernel<KIND><<<grid_blocks(n, 256), 256, 0, st>>>(
        out, k, n, summ, nb, aux);
    return (int)cudaGetLastError();
}

// summ: 2*k*nb words, aux: 4*nb words, nb = ceil(n / 512) (1 when
// n <= 1024); kind: 0 add, 1 first, 2 or.
extern "C" int launch_segscan(const void* vals, const void* starts, int k,
                              int n, int kind, void* out, void* summ,
                              void* aux, void* stream) {
    if (n == 0 || k == 0) return 0;
    const uint32_t* v = (const uint32_t*)vals;
    const unsigned char* f = (const unsigned char*)starts;
    uint32_t* o = (uint32_t*)out;
    uint32_t* s = (uint32_t*)summ;
    int* a = (int*)aux;
    cudaStream_t st = (cudaStream_t)stream;
    switch (kind) {
        case 0: return run_segscan<0>(v, f, k, n, o, s, a, st);
        case 1: return run_segscan<1>(v, f, k, n, o, s, a, st);
        case 2: return run_segscan<2>(v, f, k, n, o, s, a, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
