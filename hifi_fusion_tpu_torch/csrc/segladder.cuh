// P2's segment ladder for kernels T1 (segscan.cu) and T4 (tsdf_reduce.cu):
// the JAX package's two-level blocked segmented scan (the Pallas kernel
// block_segscan, deleted in d3b2b84; hifi_fusion_tpu/ops/
// pallas_segscan.py:74, and segment_reduce, hifi_fusion_tpu/ops/
// scatter.py:187-235), step for step:
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
// word: the left operand), 2 "or" (32-bit words).
//
// The block ladder runs in registers, one warp a channel of a block: thread
// t holds lanes t, t + 32, ..., t + 32 (R - 1) in R registers (16 for a
// 512-lane block, 32 for the flat ladder), so every load and store of a
// register is 128 contiguous bytes a warp; a step at distance s < 32 is one
// shuffle a register, a step at s >= 32 moves the thread's own registers.
// It runs with no barrier and no shared memory.  The flags run their own
// ladder first, one bit a lane (ladder_masks), so the value steps need no
// flag traffic.  Through shared memory the ladder would move 9 steps x 2
// words a lane and channel through the SM's 128 B/clock and wait at a
// barrier every step, more time than the lanes' bytes take.
#pragma once

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

// the ladder's steps for R registers a thread: log2(32 R)
template <int R>
__host__ __device__ constexpr int ladder_steps() { return R == 16 ? 9 : 10; }

// The flag ladder of one block as one bit a lane: fb bit r is the start
// flag of lane 32 r + t; mask[j] bit r becomes the flag of that lane
// before step j (its flag-OR over the 2^j lanes ending at it).
template <int R>
__device__ __forceinline__ void ladder_masks(uint32_t fb, int wl,
                                             uint32_t* mask) {
    constexpr uint32_t RMASK = R == 32 ? 0xffffffffu : (1u << R) - 1u;
    mask[0] = fb;
#pragma unroll
    for (int j = 0; j + 1 < ladder_steps<R>(); ++j) {
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
}

// One CTA runs the ladder of one block of `width` lanes (512, or n <= 1024
// for the flat ladder), warp c channel c, R lanes a thread (16; 32 for the
// flat ladder).  Values are (k, n) 32-bit words, flags (n,) bytes.  With
// summ != nullptr also writes each channel's last lane to summ[c*nb +
// block], the block's flag-OR to sflag[block] and its first flagged lane
// (width if none) to first[block].
template <int KIND, int R>
__global__ void __launch_bounds__(32 * SEG_MAX_CHANNELS)
segscan_block_kernel(const uint32_t* __restrict__ vals,
                     const unsigned char* __restrict__ starts, long n,
                     int width, uint32_t* __restrict__ out,
                     uint32_t* __restrict__ summ, int* __restrict__ sflag,
                     int* __restrict__ first, int nb) {
    const int wl = threadIdx.x & 31;
    const int c = threadIdx.x >> 5;                // the warp's channel
    const long blk = blockIdx.x;
    const long base = blk * width;                 // the block's first lane
    const bool full = width == 32 * R && base + width <= n;
    auto real = [&](int r) {
        return full || (32 * r + wl < width && base + 32 * r + wl < n);
    };

    uint32_t fb = 0;
#pragma unroll
    for (int r = 0; r < R; ++r)
        if (real(r) && starts[base + 32 * r + wl]) fb |= 1u << r;
    uint32_t mask[ladder_steps<R>()];
    ladder_masks<R>(fb, wl, mask);

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
    const int mine = fb ? 32 * (__ffs(fb) - 1) + wl : 0x7fffffff;
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

// Step 2 over the nb summaries of k channels: one launch a step s < nb
// over all summaries and channels, many CTAs each, ping-ponging between
// (a, fa) and (o, fb) in device memory (16 launches at 52,800 blocks), so
// the whole card works on it.  Returns the buffer that holds the
// inclusive summary scan in *res, or a CUDA error.
template <int KIND>
static inline int summary_ladder(uint32_t* a, int* fa, uint32_t* o, int* fb,
                                 int k, int nb, uint32_t** res,
                                 cudaStream_t st) {
    for (int s = 1; s < nb; s <<= 1) {
        segscan_summary_step<KIND><<<grid_blocks(nb, 256), 256, 0, st>>>(
            a, fa, o, fb, k, nb, s);
        const int rc = (int)cudaGetLastError();
        if (rc) return rc;
        uint32_t* tv = a; a = o; o = tv;
        int* tf = fa; fa = fb; fb = tf;
    }
    *res = a;
    return 0;
}

// Step 2's inclusive value at one summary p, for a segment whose flag-OR
// is set at summary p - w + 1 and at none of the w - 1 after it, for KIND
// "add", from those w summaries x[0, w): the value the summary ladder
// leaves at p, from the same additions in the same tree.
//
// Why: inside the window only x[0] is flagged, so at the step of distance
// s a summary q >= s adds the one s before it and a summary q < s keeps its
// value (it reaches the flag).  By induction, after the steps of distance
// below 2^j a summary q >= 2^j - 1 holds the pairwise tree sum of
// x[q - 2^j + 1, q], and the last step that changes q (distance h, the
// highest power of two <= q) adds summary q - h's final value to the tree
// sum of the h summaries ending at q.  So for q = w - 1 with its bits
// h_1 < h_2 < ... : ((x[0] + T(h_1)) + T(h_2)) + ..., where T(h) is the
// pairwise tree sum of the next h summaries (pairs (0,1), (2,3), ..., then
// pairs of pairs).  Nothing before x[0] is read: the zero-combine of step
// 2 never reaches a flagged segment.
//
// One warp, every lane calling; x(i) reads summary i of the window; the
// result is returned to every lane.  A window of w = 1 is x(0) itself.
template <class X>
__device__ __forceinline__ float window_prefix(X x, int w) {
    const int wl = threadIdx.x & 31;
    float acc = __shfl_sync(0xffffffffu, wl == 0 ? x(0) : 0.0f, 0);
    const int q = w - 1;
    int lo = 1;
    for (int h = 1; h <= q; h <<= 1) {
        if (!(q & h)) continue;
        // T(h) over x[lo, lo + h): each lane the tree of its h / 32
        // consecutive summaries (h >= 32) by a binary counter of partial
        // sums, then the lanes' pairs of the warp
        const int per = h >= 32 ? h / 32 : 1;
        float t = 0.0f;
        if (wl < h) {
            float stack[27];
            int top = 0;
            for (int e = 0; e < per; ++e) {
                float v = x(lo + wl * per + e);
                for (int m = e + 1; !(m & 1); m >>= 1)
                    v = __fadd_rn(stack[--top], v);
                stack[top++] = v;
            }
            t = stack[0];
        }
        for (int d = 1; d < 32 && d < h; d <<= 1) {
            const float y = __shfl_down_sync(0xffffffffu, t, d);
            if ((wl & (2 * d - 1)) == 0) t = __fadd_rn(t, y);
        }
        acc = __fadd_rn(acc, __shfl_sync(0xffffffffu, t, 0));
        lo += h;
    }
    return acc;
}
