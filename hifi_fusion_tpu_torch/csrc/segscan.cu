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
// (0 + -0.0 = +0.0), as XLA computes it.  A work-efficient scan would add
// in another order, so none is used.
//
// Kinds: 0 "add" (f32, round-to-nearest adds), 1 "first" (any 32-bit
// word: the left operand), 2 "or" (32-bit words).  Values are (k, n)
// 32-bit words, flags (n,) bytes.
//
// Bound on the card: memory.  Each lane reads k x 4 B of values and a
// 1 B flag and writes k x 4 B: at the TSDF config-5 batch (k = 6,
// 27,033,600 lanes) 49 B a lane, 1.32 GB, ~0.40 ms at 3.35 TB/s.  The
// ladder itself must cost less than that: through shared memory it would
// move 9 steps x 2 words a lane and channel through the SM's 128 B/clock
// and wait at a barrier every step, more time than the bytes take.
//
// Design:
//   * block pass, one CTA per 512-lane block, one warp per channel, no
//     shared memory: thread t holds lanes t, t + 32, ..., t + 480 of its
//     channel in 16 registers, so every load and store is 128 contiguous
//     bytes a warp; a step at distance s < 32 is one shuffle a register,
//     a step at s >= 32 moves the thread's own registers.  The ladder runs
//     with no barrier, and the k channels of a block take each step
//     together, side by side.  Each warp runs the flag ladder itself, one
//     bit a lane (the block's 512 flag bytes come from L1 after the first
//     warp), leaving each thread one mask word a step.  The pass writes
//     each block's summary (the last lane, every channel), its flag-OR and
//     its first flagged lane.  n <= 1024 is one flat ladder: one CTA, 32
//     lanes a thread.
//   * summary pass, one launch per ladder step s < nb over all summaries
//     and channels, many CTAs each, ping-ponging between two buffers in
//     device memory (16 launches at config 5), so the whole card works on
//     it.
//   * combine pass, one warp per block over the lanes before the block's
//     first flag only (from the first flag on, the block pass's lanes are
//     final).

#include <limits.h>

#include "common.cuh"

#define SEG_BS 512
#define SEG_MAX_CHANNELS 16

template <int KIND>
__device__ __forceinline__ uint32_t seg_op(uint32_t left, uint32_t here) {
    if (KIND == 0)
        return __float_as_uint(
            __fadd_rn(__uint_as_float(left), __uint_as_float(here)));
    if (KIND == 2) return left | here;
    return left;
}

// One ladder step at distance S on one channel of a block, R registers a
// thread: lane 32 r + t of the block is register r of thread t.  For
// S < 32 register r's left operand comes from thread (t - S) mod 32, which
// sends its register r, or r - 1 where the distance wraps round the warp
// (zero for r = 0: no left neighbour inside the block), one shuffle a
// register; for S >= 32 it is the thread's own register r - S / 32, or
// zero.  Registers go from the last down, so every operand is the
// pre-step value.  keep bit r: lane r's flag before the step (the lane
// keeps its value).  S is a template parameter so that every register
// index is a constant and the arrays stay in registers.
template <int KIND, int R, int S>
__device__ __forceinline__ void ladder_step(uint32_t (&v)[R], uint32_t keep,
                                            int wl) {
    if constexpr (S < 32) {
        const bool wrap = wl + S >= 32;
        const int src = (wl - S) & 31;
#pragma unroll
        for (int r = R - 1; r >= 1; --r) {
            const uint32_t x =
                __shfl_sync(0xffffffffu, wrap ? v[r - 1] : v[r], src);
            if (!((keep >> r) & 1u)) v[r] = seg_op<KIND>(x, v[r]);
        }
        const uint32_t x = __shfl_sync(0xffffffffu, wrap ? 0u : v[0], src);
        if (!(keep & 1u)) v[0] = seg_op<KIND>(x, v[0]);
    } else {
        constexpr int M = S / 32;
#pragma unroll
        for (int r = R - 1; r >= M; --r)
            if (!((keep >> r) & 1u)) v[r] = seg_op<KIND>(v[r - M], v[r]);
        // the lanes below the distance combine with zero; those below half
        // of it did so at the step before, with the same flag (op(0,
        // op(0, x)) is op(0, x) for every kind), so [S/2, S) is left
#pragma unroll
        for (int r = M - 1; r >= M / 2; --r)
            if (!((keep >> r) & 1u)) v[r] = seg_op<KIND>(0u, v[r]);
    }
}

// Steps J, J + 1, ... of the ladder (distance 2^J) on one channel, each
// step while its distance is below the block's width.
template <int KIND, int R, int J>
__device__ __forceinline__ void ladder(uint32_t (&v)[R], const uint32_t* mask,
                                       int width, int wl) {
    if constexpr ((1 << J) < 32 * R) {
        if ((1 << J) >= width) return;
        ladder_step<KIND, R, (1 << J)>(v, mask[J], wl);
        ladder<KIND, R, J + 1>(v, mask, width, wl);
    }
}

// One CTA runs the ladder of one block of `width` lanes (512, or n <= 1024
// for the flat ladder), warp c channel c, R lanes a thread (16; 32 for the
// flat ladder).  Each warp runs the flag ladder first, as one bit a lane:
// mask[j] bit r is the flag of lane 32 r + t before step j, so the value
// steps need no flag traffic.  Every load and store of register r covers
// 32 consecutive lanes (128 B of a channel).  With summ != nullptr also
// writes each channel's last lane to summ[c*nb + block], the block's
// flag-OR to sflag[block] and its first flagged lane (width if none) to
// first[block].
template <int KIND, int R>
__global__ void __launch_bounds__(32 * SEG_MAX_CHANNELS)
segscan_block_kernel(const uint32_t* __restrict__ vals,
                     const unsigned char* __restrict__ starts, long n,
                     int width, uint32_t* __restrict__ out,
                     uint32_t* __restrict__ summ, int* __restrict__ sflag,
                     int* __restrict__ first, int nb) {
    constexpr int STEPS = R == 16 ? 9 : 10;       // log2(32 * R)
    constexpr uint32_t RMASK = R == 32 ? 0xffffffffu : (1u << R) - 1u;
    const int wl = threadIdx.x & 31;
    const int c = threadIdx.x >> 5;                // the warp's channel
    const long blk = blockIdx.x;
    const long base = blk * width;                 // the block's first lane
    const bool full = width == 32 * R && base + width <= n;
    auto real = [&](int r) {
        return full || (32 * r + wl < width && base + 32 * r + wl < n);
    };

    // the lanes' start flags, bit r for lane 32 r + t
    uint32_t fb = 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
        if (real(r) && starts[base + 32 * r + wl]) fb |= 1u << r;
    // the flag ladder: mask[j] = flags before step j
    uint32_t mask[STEPS];
    mask[0] = fb;
#pragma unroll
    for (int j = 0; j + 1 < STEPS; ++j) {
        const int s = 1 << j;
        uint32_t m = mask[j];
        if (s < 32) {
            const uint32_t up = __shfl_sync(0xffffffffu, m, (wl - s) & 31);
            m |= wl >= s ? up : (up << 1) & RMASK;
        } else {
            m |= (m << (s / 32)) & RMASK;
        }
        mask[j + 1] = m;
    }

    const uint32_t* row = vals + (long)c * n + base + wl;
    uint32_t v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = real(r) ? row[32 * r] : 0u;
    ladder<KIND, R, 0>(v, mask, width, wl);
    uint32_t* orow = out + (long)c * n + base + wl;
#pragma unroll
    for (int r = 0; r < R; ++r)
        if (real(r)) orow[32 * r] = v[r];
    if (summ == nullptr) return;
    if (wl == 31) summ[(long)c * nb + blk] = v[R - 1];
    if (c > 0) return;
    const int mine = fb ? 32 * (__ffs(fb) - 1) + wl : INT_MAX;
    const int fi = __reduce_min_sync(0xffffffffu, mine);
    if (wl == 0) {
        first[blk] = fi < width ? fi : width;
        sflag[blk] = fi < width;
    }
}

// One ladder step at distance s over the nb block summaries, every channel:
// (src, sf) -> (dst, df), zero-filled for b < s.
template <int KIND>
__global__ void segscan_summary_step(const uint32_t* __restrict__ src,
                                     const int* __restrict__ sf,
                                     uint32_t* __restrict__ dst,
                                     int* __restrict__ df, int k, int nb,
                                     int s) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= nb) return;
    const int f = sf[b];
    df[b] = f | (b >= s ? sf[b - s] : 0);
    for (int c = 0; c < k; ++c) {
        const uint32_t* row = src + (long)c * nb;
        uint32_t v = row[b];
        if (!f) v = seg_op<KIND>(b >= s ? row[b - s] : 0u, v);
        dst[(long)c * nb + b] = v;
    }
}

// out = op(ev, vv) for the lanes before their block's first flag, one warp
// per block, every channel; summ holds the inclusive summary scan.
template <int KIND>
__global__ void segscan_combine_kernel(uint32_t* __restrict__ out, int k,
                                       long n,
                                       const uint32_t* __restrict__ summ,
                                       int nb, const int* __restrict__ first) {
    const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (b >= nb) return;
    const long base = (long)b * SEG_BS;
    const long lim = min((long)first[b], n - base);
    for (long t = threadIdx.x & 31; t < lim; t += 32) {
        for (int c = 0; c < k; ++c) {
            const uint32_t ev = b > 0 ? summ[(long)c * nb + b - 1] : 0u;
            const long i = (long)c * n + base + t;
            out[i] = seg_op<KIND>(ev, out[i]);
        }
    }
}

template <int KIND>
static int run_segscan(const uint32_t* vals, const unsigned char* starts,
                       int k, long n, uint32_t* out, uint32_t* summ, int* aux,
                       cudaStream_t st) {
    if (n <= 2 * SEG_BS) {
        segscan_block_kernel<KIND, 32><<<1, 32 * k, 0, st>>>(
            vals, starts, n, (int)n, out, nullptr, nullptr, nullptr, 1);
        return (int)cudaGetLastError();
    }
    const int nb = (int)((n + SEG_BS - 1) / SEG_BS);
    int* first = aux;
    int* fa = aux + nb;
    int* fb = aux + 2 * (long)nb;
    uint32_t* a = summ;
    uint32_t* o = summ + (long)k * nb;
    segscan_block_kernel<KIND, 16><<<nb, 32 * k, 0, st>>>(
        vals, starts, n, SEG_BS, out, a, fa, first, nb);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    for (int s = 1; s < nb; s <<= 1) {
        segscan_summary_step<KIND><<<grid_blocks(nb, 256), 256, 0, st>>>(
            a, fa, o, fb, k, nb, s);
        rc = (int)cudaGetLastError();
        if (rc) return rc;
        uint32_t* tv = a; a = o; o = tv;
        int* tf = fa; fa = fb; fb = tf;
    }
    segscan_combine_kernel<KIND><<<grid_blocks(nb, 4), 128, 0, st>>>(
        out, k, n, a, nb, first);
    return (int)cudaGetLastError();
}

// summ: 2*k*nb words, aux: 3*nb words, nb = ceil(n / 512) (1 when
// n <= 1024); k <= 16; kind: 0 add, 1 first, 2 or.
extern "C" int launch_segscan(const void* vals, const void* starts, int k,
                              int n, int kind, void* out, void* summ,
                              void* aux, void* stream) {
    if (n == 0 || k == 0) return 0;
    if (k > SEG_MAX_CHANNELS) return (int)cudaErrorInvalidValue;
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
