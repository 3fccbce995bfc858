// Kernel T4: the TSDF batch reduce, from the sort's output straight into
// the grid.
//
// Replaces: _tsdf_reduce in hifi_fusion_tpu/models/tsdf.py :135-182 after
// its sort, and P2's ladder with it (the Pallas kernel block_segscan,
// deleted in d3b2b84; hifi_fusion_tpu/ops/pallas_segscan.py:74): the six
// channels in sorted order, their segmented sums (segment_sums,
// hifi_fusion_tpu/ops/scatter.py:187-235), the run starts and ends of the
// sorted ids, the first U runs' ids and six-channel sums compacted
// (argsort(~starts)[:U], argsort(~ends)[:U]), overflow_unique +=
// max(n_u - U, 0) (and the port's unique_cells += min(n_u, U)), the
// find-or-insert of those ids and one add of each
// placed cell's sums into vstats.  Its plain version
// (models/tsdf.py tsdf_reduce_plain) gathers the channels, runs T1's plain
// ladder and compacts with two torch.nonzero calls and a count, each a
// read back to the host; here every count stays on the card.
//
// Input: the M sorted ids (INVALID_ID = INT32_MAX last), the sort's i32
// order (kernel T5, tsdf_sort.cu) and the (6, M) channels in the sample
// map's lane order.
//
// Bound on the card: memory.  Each lane's sorted id (4 B) and order word
// (4 B) are read once and its six values through the order (24 B); per
// kept run its key probe (K2), per new cell its key written, per placed
// cell its six vstats words read and written (48 B).  bounds.tsdf_reduce
// (~1.04 GB at phase 3's shape), like the benchmark's frozen copy of it,
// still counts an 8-byte order word, the i64 order T4 read before T5, so
// it overstates these bytes by 4 of 36 B a lane.  The six values are the
// one random stream: a 4-byte word of a 32-byte sector in each of six
// planes, whose neighbours in the sector other lanes of nearby runs may
// want, so the sectors that miss the L2, not the bytes counted, hold the
// runs pass (timed with kernel_ab.py: the same pass reading the planes in
// lane order instead of through the order takes about a third of the
// time, and gathering all six channels from one plane about 0.7 of it).
// No tensor cores: there is no product.
//
// What the design does about the bound: nothing full-width leaves the SM.
// The gathered planes and T1's running sums (2 x 648 MB at phase 3's
// shape, written and read back) never exist; per run only its id and six
// sums (28 B) are written.  The ladder adds in the JAX package's order,
// so vstats is bit-identical to the plain version's and the JAX
// package's.
//
// Design: a memset and two launches before K2, one launch after it, no
// host read (launch_tsdf_reduce_runs, launch_tsdf_reduce_scatter):
//  0. one cudaMemsetAsync zeroes the scratch: the live count and the run
//     scan's tile counter and look-back words;
//  1. the runs pass, a CTA a tile of T4_BLOCKS 512-lane ladder blocks
//     (RUN_SCAN_TILE lanes), tiles in the order the CTAs start
//     (csrc/scan.cuh).  The CTA loads the tile's sorted ids and order
//     words once, with 16-byte loads, into shared memory, with the one id
//     on each side of the tile.  Warp w
//     takes ladder block w: its lanes' start flags (a valid id other than
//     its predecessor's) and end flags (other than its successor's), one
//     bit a lane, and a ballot a register row, whose popcounts number the
//     block's runs.  The tile's run count goes through the decoupled
//     look-back, which gives each lane the index r of its run.  A start
//     lane writes uids[r] for r < U.  Then for each channel the warp
//     gathers its block's 512 words through the order, 16 independent
//     loads a thread, and runs P2's in-block ladder on them in registers
//     (segladder.cuh); each end lane of a run r < U writes its value to
//     usums[c, r] (consecutive runs to consecutive words), and the
//     block's last lane the block's summary.  The block's flag-OR goes to
//     sflag.  The last valid lane of the batch ends run n_u - 1: its
//     thread writes the live count min(n_u, U), adds it into unique_cells
//     and adds max(n_u - U, 0) into overflow_unique; with no valid lane
//     the live count stays 0 and neither counter moves.
//     M <= 1024 is P2's flat ladder: one CTA, one block of M lanes, 32 a
//     thread, warp c channel c, and no carries.
//  2. the carries, a thread a ladder block.  A run's end value is final
//     where a start lies in its block at or before it; else (at most one
//     run a block: the one that entered it and ends before its first
//     start) it is ev[b] + vv (scatter.py step 3), with ev[b] the summary
//     ladder's value at block b - 1.  The runs pass names that run in
//     carry[b] (-1 for none, or for a run past U).  Inside a segment of
//     summaries only its first is flagged, so the summary ladder's value
//     at b - 1 follows from the summaries of blocks k..b-1 alone, k the
//     block where the run began, in the ladder's own tree
//     (segladder.cuh window_prefix): exact for a run of any length.  In
//     the common case the run began in block b - 1 and ev[b] is that
//     block's last lane, which the thread adds into the run's six usums;
//     a run that crossed a block with no start takes its whole warp.
// Then K2 finds or inserts uids[0, live) (hashing.lookup_or_insert with
// the live count; it touches no lane past it), adding its failures into
// overflow_probe.  After it:
//  3. the scatter, a thread a compacted run r < live: where its slot is
//     placed (>= 0) it adds the six sums into vstats[6 slot, 6 slot + 6).
//     The run ids are distinct, so their slots are: one plain
//     read-add-write of the 24-byte row (a 16-byte and an 8-byte access),
//     no atomics, and each cell's words take one f32 add, as index_add_
//     and the JAX package's scatter_add do, so vstats is theirs bit for
//     bit.  The rows are random in a 400 MB array: random sectors bound
//     it.
// K2's slots may differ from the plain version's (its CAS race against
// the first-in-input-order election); the grid is the same by cell id.

#include "scan.cuh"
#include "segladder.cuh"

// ladder blocks a tile of the runs pass: a warp each, RUN_SCAN_TILE lanes
constexpr int T4_BLOCKS = SCAN_WARPS;
constexpr int T4_TILE = T4_BLOCKS * SEG_BS;
static_assert(T4_TILE == RUN_SCAN_TILE, "a tile is a run-scan tile");

// R lanes a thread: 16 (512-lane blocks, T4_BLOCKS a tile) or 32 (the flat
// ladder of M <= 1024 lanes, warp c channel c)
template <int R>
static __global__ void __launch_bounds__(SCAN_THREADS, 2)
t4_runs_kernel(const int* __restrict__ sid,
               const int* __restrict__ order,
               const float* __restrict__ vals6, int M, int U, int tiles,
               int nb, int* __restrict__ uids, float* __restrict__ usums,
               int* __restrict__ n_live, int* __restrict__ overflow_unique,
               long long* __restrict__ unique_cells,
               float* __restrict__ summ, int* __restrict__ sflag,
               int* __restrict__ carry, int* __restrict__ scratch) {
    constexpr bool FLAT = R == 32;
    // lane l's id at ids_s[4 + l], the predecessor of the tile's first
    // lane at ids_s[3], the successor of its last at ids_s[4 + T4_TILE]
    __shared__ __align__(16) int ids_s[T4_TILE + 8];
    __shared__ __align__(16) int ord_s[T4_TILE];
    __shared__ int wcnt[SCAN_WARPS];
    const LookBack lb(scratch, tiles);
    const int tile = next_tile(lb.counter);
    const int tbase = tile * T4_TILE;
    const int tn = min(T4_TILE, M - tbase);    // the tile's lanes
    const int tid = threadIdx.x;
    if (tn == T4_TILE && ((reinterpret_cast<uintptr_t>(sid)
                           | reinterpret_cast<uintptr_t>(order)) & 15) == 0) {
        constexpr int NI = T4_TILE / 4 / SCAN_THREADS;
        const int4* s4 = reinterpret_cast<const int4*>(sid + tbase);
        const int4* o4 = reinterpret_cast<const int4*>(order + tbase);
        int4 a[NI], o[NI];
#pragma unroll
        for (int i = 0; i < NI; ++i) a[i] = s4[tid + i * SCAN_THREADS];
#pragma unroll
        for (int i = 0; i < NI; ++i) o[i] = o4[tid + i * SCAN_THREADS];
#pragma unroll
        for (int i = 0; i < NI; ++i) {
            reinterpret_cast<int4*>(ids_s + 4)[tid + i * SCAN_THREADS] = a[i];
            reinterpret_cast<int4*>(ord_s)[tid + i * SCAN_THREADS] = o[i];
        }
    } else {
        for (int l = tid; l < T4_TILE; l += SCAN_THREADS) {
            ids_s[4 + l] = l < tn ? sid[tbase + l] : INVALID_ID;
            ord_s[l] = l < tn ? order[tbase + l] : 0;
        }
    }
    if (tid == 0) ids_s[3] = tbase > 0 ? sid[tbase - 1] : INVALID_ID;
    if (tid == 1)
        ids_s[4 + T4_TILE] = tn == T4_TILE && tbase + T4_TILE < M
                                 ? sid[tbase + T4_TILE] : INVALID_ID;
    __syncthreads();

    const int wl = tid & 31, w = tid >> 5;
    const int lb0 = FLAT ? 0 : SEG_BS * w;         // the block's first lane
    const int bw = FLAT ? tn : min(SEG_BS, tn - lb0);   // its real lanes
    const bool active = FLAT ? w < 6 : bw > 0;
    const int b = tile * T4_BLOCKS + w;            // its ladder block
    // bit r: lane lb0 + 32 r + wl starts / ends a run; sb[r]: the starts
    // of register row r, a bit a thread
    uint32_t fb = 0, eb = 0, sb[R];
    int bcnt = 0;
    if (active) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int l = lb0 + 32 * r + wl;
            const int id = ids_s[4 + l];
            const bool real = 32 * r + wl < bw && id != INVALID_ID;
            const bool start = real && id != ids_s[3 + l];
            const bool end = real && id != ids_s[5 + l];
            fb |= (uint32_t)start << r;
            eb |= (uint32_t)end << r;
            sb[r] = __ballot_sync(FULL_MASK, start);
            bcnt += __popc(sb[r]);
        }
    }
    if (wl == 0) wcnt[w] = active ? bcnt : 0;
    __syncthreads();
    int agg = 0, bpre = 0;
#pragma unroll
    for (int i = 0; i < SCAN_WARPS; ++i) {
        agg += FLAT ? (i == 0 ? wcnt[i] : 0) : wcnt[i];
        if (!FLAT && i < w) bpre += wcnt[i];
    }
    const int before = tile_prefix(lb, tile, agg);     // syncs the block
    if (!active) return;

    // run[r]: the run of lane (r, wl), for its starts and ends: the runs
    // begun before its block, plus the block's starts up to it, less one
    // (a lane before the block's first start continues the run begun
    // before the block)
    const uint32_t le = (2u << wl) - 1u;
    const bool writer = !FLAT || w == 0;
    int run[R];
    bool cross = false;
    int cross_run = -1;
    int pre = before + bpre - 1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int cnt = __popc(sb[r] & le);
        run[r] = pre + cnt;
        pre += __popc(sb[r]);
        const int l = lb0 + 32 * r + wl;
        if (writer && ((fb >> r) & 1u) && run[r] < U)
            uids[run[r]] = ids_s[4 + l];
        if (!((eb >> r) & 1u)) continue;
        if (run[r] == before + bpre - 1) {          // entered the block
            cross = true;
            cross_run = run[r];
        }
        if (writer && ids_s[5 + l] == INVALID_ID) {
            // the batch's last valid lane ends run n_u - 1
            if (run[r] < U) {
                *n_live = run[r] + 1;
            } else {
                *n_live = U;
                *overflow_unique += run[r] + 1 - U;
            }
            *unique_cells += min(run[r] + 1, U);
        }
    }
    if (!FLAT) {
        const bool any = __any_sync(FULL_MASK, cross);
        if (cross) carry[b] = cross_run < U ? cross_run : -1;
        else if (wl == 0 && !any) carry[b] = -1;
        if (wl == 0) sflag[b] = bcnt > 0;
    }

    uint32_t mask[ladder_steps<R>()];
    ladder_masks<R>(fb, wl, mask);
    const int width = FLAT ? tn : SEG_BS;
    const int c0 = FLAT ? w : 0, c1 = FLAT ? w + 1 : 6;
    for (int c = c0; c < c1; ++c) {
        const float* row = vals6 + (long)c * M;
        uint32_t v[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
            v[r] = 32 * r + wl < bw
                       ? __float_as_uint(__ldg(row + ord_s[lb0 + 32 * r + wl]))
                       : 0u;
        ladder<0, R, 0>(v, mask, width, wl);
        if (!FLAT && wl == 31) summ[(long)c * nb + b] = __uint_as_float(v[R - 1]);
        float* out = usums + (long)c * U;
#pragma unroll
        for (int r = 0; r < R; ++r)
            if (((eb >> r) & 1u) && run[r] < U)
                out[run[r]] = __uint_as_float(v[r]);
    }
}

// Step 2 of the ladder for the runs that entered their block: usums[:, r]
// += ev (ev + vv) for r = carry[b], a thread a block.  Where block b - 1
// holds a run start, ev is its summary; otherwise the thread's warp walks
// back to the block where the run began and takes window_prefix over the
// blocks between, one such block at a time.
static __global__ void t4_carry_kernel(int nb, int U,
                                       const int* __restrict__ carry,
                                       const float* __restrict__ summ,
                                       const int* __restrict__ sflag,
                                       float* __restrict__ usums) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    const int r = b > 0 && b < nb ? carry[b] : -1;
    const bool near = r >= 0 && sflag[b - 1];
    if (near) {
#pragma unroll
        for (int c = 0; c < 6; ++c) {
            float* u = usums + (long)c * U + r;
            *u = __fadd_rn(summ[(long)c * nb + b - 1], *u);
        }
    }
    const int wl = threadIdx.x & 31;
    for (unsigned far = __ballot_sync(FULL_MASK, r >= 0 && !near); far;
         far &= far - 1) {
        const int src = __ffs(far) - 1;
        const int fb = __shfl_sync(FULL_MASK, b, src);
        const int fr = __shfl_sync(FULL_MASK, r, src);
        // k: the nearest flagged block before fb, where the run began
        int k = fb - 1;
        for (int hi = fb - 2; hi >= 0; hi -= 32) {
            const int j = hi - wl;
            const unsigned m = __ballot_sync(FULL_MASK, j >= 0 && sflag[j]);
            if (m) {
                k = hi - (__ffs(m) - 1);
                break;
            }
        }
        for (int c = 0; c < 6; ++c) {
            const float* x = summ + (long)c * nb + k;
            const float ev =
                window_prefix([&](int i) { return x[i]; }, fb - k);
            if (wl == 0) {
                float* u = usums + (long)c * U + fr;
                *u = __fadd_rn(ev, *u);
            }
        }
    }
}

static __global__ void t4_scatter_kernel(int U, const int* __restrict__
                                         n_live,
                                         const int* __restrict__ uslot,
                                         const float* __restrict__ usums,
                                         float* __restrict__ vstats) {
    const int n = *n_live;
    for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < n;
         r += gridDim.x * blockDim.x) {
        const int s = uslot[r];
        if (s < 0) continue;                    // the probe bound failed
        float v[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) v[c] = usums[(long)c * U + r];
        // a row is 24 bytes at 8-byte alignment: a 16-byte and an 8-byte
        // access, in the order its alignment allows
        float* row = vstats + 6L * s;
        if ((s & 1) == 0) {
            float4 a = *reinterpret_cast<float4*>(row);
            float2 b = *reinterpret_cast<float2*>(row + 4);
            a.x = __fadd_rn(a.x, v[0]);
            a.y = __fadd_rn(a.y, v[1]);
            a.z = __fadd_rn(a.z, v[2]);
            a.w = __fadd_rn(a.w, v[3]);
            b.x = __fadd_rn(b.x, v[4]);
            b.y = __fadd_rn(b.y, v[5]);
            *reinterpret_cast<float4*>(row) = a;
            *reinterpret_cast<float2*>(row + 4) = b;
        } else {
            float2 a = *reinterpret_cast<float2*>(row);
            float4 b = *reinterpret_cast<float4*>(row + 2);
            a.x = __fadd_rn(a.x, v[0]);
            a.y = __fadd_rn(a.y, v[1]);
            b.x = __fadd_rn(b.x, v[2]);
            b.y = __fadd_rn(b.y, v[3]);
            b.z = __fadd_rn(b.z, v[4]);
            b.w = __fadd_rn(b.w, v[5]);
            *reinterpret_cast<float2*>(row) = a;
            *reinterpret_cast<float4*>(row + 2) = b;
        }
    }
}

static inline long t4_scratch_words(int M) {
    return 2 + lookback_words(M, T4_TILE);
}

// Before K2: the memset, the runs pass and the carries.  ``scratch``
// holds t4_scratch_words(M) ints: [live count, pad, the run scan's
// look-back]; ``aux`` 8 * nb ints, nb = ceil(M / 512): the block
// summaries (6 rows of f32), their flag-ORs and the carries.
extern "C" int launch_tsdf_reduce_runs(const void* sid, const void* order,
                                       const void* vals6, int M, int U,
                                       void* uids, void* usums,
                                       void* overflow_unique,
                                       void* unique_cells, void* scratch,
                                       long words, void* aux, void* stream) {
    if (words < t4_scratch_words(M)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    int* sc = (int*)scratch;
    const cudaError_t e =
        cudaMemsetAsync(sc, 0, t4_scratch_words(M) * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    if (M == 0) return 0;
    const int nb = grid_blocks(M, SEG_BS);
    const int tiles = grid_blocks(M, T4_TILE);
    float* summ = (float*)aux;
    int* sflag = (int*)aux + 6L * nb;
    int* carry = (int*)aux + 7L * nb;
    if (M <= 2 * SEG_BS) {
        t4_runs_kernel<32><<<1, SCAN_THREADS, 0, st>>>(
            (const int*)sid, (const int*)order, (const float*)vals6, M,
            U, tiles, nb, (int*)uids, (float*)usums, sc,
            (int*)overflow_unique, (long long*)unique_cells, summ, sflag,
            carry, sc + 2);
        return (int)cudaGetLastError();
    }
    t4_runs_kernel<16><<<tiles, SCAN_THREADS, 0, st>>>(
        (const int*)sid, (const int*)order, (const float*)vals6, M, U,
        tiles, nb, (int*)uids, (float*)usums, sc, (int*)overflow_unique,
        (long long*)unique_cells, summ, sflag, carry, sc + 2);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
    t4_carry_kernel<<<grid_blocks(nb, 256), 256, 0, st>>>(
        nb, U, carry, summ, sflag, (float*)usums);
    return (int)cudaGetLastError();
}

// After K2 (uslot): the scatter of the live runs' sums into vstats.
extern "C" int launch_tsdf_reduce_scatter(int U, const void* scratch,
                                          const void* uslot,
                                          const void* usums, void* vstats,
                                          void* stream) {
    if (U == 0) return 0;
    constexpr int threads = 256;
    t4_scatter_kernel<<<grid_blocks(U, threads), threads, 0,
                        (cudaStream_t)stream>>>(
        U, (const int*)scratch, (const int*)uslot, (const float*)usums,
        (float*)vstats);
    return (int)cudaGetLastError();
}
