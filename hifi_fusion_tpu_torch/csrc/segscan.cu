// Kernel T1: the two-level blocked segmented scan (add / first / or).
//
// Replaces: the Pallas kernel block_segscan (P2, deleted in d3b2b84;
// hifi_fusion_tpu/ops/pallas_segscan.py:74), the in-block phase of
// segment_reduce (hifi_fusion_tpu/ops/scatter.py:167-235), and the rest of
// segment_reduce with it, step for step as the JAX package's ladder
// (segladder.cuh, which kernel T4 shares).  Values are (k, n) 32-bit
// words, flags (n,) bytes.
//
// Bound on the card: memory.  Each lane reads k x 4 B of values and a
// 1 B flag and writes k x 4 B: at the TSDF config-5 batch (k = 6,
// 27,033,600 lanes) 49 B a lane, 1.32 GB, ~0.40 ms at 3.35 TB/s.  The
// ladder runs in registers (segladder.cuh), so the bytes bound it.
//
// Design:
//   * block pass, one CTA per 512-lane block, one warp per channel
//     (segscan_block_kernel): the channels of a block take each step
//     together, side by side.  It writes each block's summary (the last
//     lane, every channel), its flag-OR and its first flagged lane.
//     n <= 1024 is one flat ladder: one CTA, 32 lanes a thread.
//   * summary pass (summary_ladder), one launch per ladder step s < nb
//     over all summaries and channels.
//   * combine pass, one warp per block over the lanes before the block's
//     first flag only (from the first flag on, the block pass's lanes are
//     final).

#include "segladder.cuh"

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
    rc = summary_ladder<KIND>(a, fa, o, fb, k, nb, &a, st);
    if (rc) return rc;
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
