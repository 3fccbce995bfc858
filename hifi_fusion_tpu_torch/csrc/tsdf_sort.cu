// Kernel T5: the TSDF batch sort, a stable radix sort of the sample
// lanes' cell ids by their dense rank.
//
// Replaces: the stable sort of a batch in _tsdf_reduce
// (hifi_fusion_tpu/models/tsdf.py :147-149, jax.lax.sort of the ids with
// the six channels carried as operands), not a Pallas kernel.  The port
// carries no channel: it sorts the ids with each lane's index, and T4
// (tsdf_reduce.cu) gathers the channels through that order.  Its plain
// version (models/tsdf.py sort_lanes_plain) is torch.sort(stable=True)
// with the order cast to i32; a stable sort's output is unique, so the
// two agree id for id and index for index.
//
// Input: M cell ids, each in [0, n_cells) or INVALID_ID (an invalid
// lane).  Output: sid, the ids ascending with INVALID_ID last, and order,
// the i32 lane of each, equal ids in lane order.  An id outside
// [0, n_cells) other than INVALID_ID is counted (counts[2]) and ranks
// with the invalid lanes; its place and the id written for it are
// undefined.
//
// Bound on the card: memory.  The function's own I/O is 12 B a lane (the
// ids read, sid and order written; bounds.tsdf_sort), ~0.44 GB at the
// tsdf512 cell's 36,864,000 lanes.  A full-width sort of the 32-bit ids
// with an i64 order reads and writes 12 B a lane in each of four 8-bit
// passes (~3.5 GB there).  Yet a batch's lanes fall into few distinct
// cells (25.7-38.1 k of that grid's 38.6 M; ~1.24 M of the 383 M at
// config 5), so the ids' order is carried by far fewer bits than the ids
// have.
//
// What the rank does about it: a lane is sorted by its id's dense rank,
// the id's position among the batch's D distinct ids (an invalid lane
// ranks D), which keeps the ids' order and needs only as many 8-bit
// digits as D has: one pass while D < 2^8, two while D < 2^16 (every
// batch of that cell), three below 2^24 (config 5), four beyond.  D is
// found on the card and the passes it does not need exit at once, so
// nothing is read back to the host; the launcher launches the passes
// min(M, n_cells) could need.  The histogram sweep writes each lane's
// rank, so the passes carry (rank, lane) pairs and look nothing up; the
// last pass turns a rank back into its id through the ranks' inverse (D
// ints, in the L2), or, for a batch of T5_INV_CAP distinct ids or more,
// by reading the lane's id.
//
// The tables (the caller's, kept between sorts: models/tsdf.py
// SortTables): a bitmap of the grid's cells (n_cells / 8 bytes), a
// summary bit a bitmap word (n_cells / 256 bytes), both zero between
// sorts; the rank prefix of each bitmap word (n_cells / 8 bytes, written
// only where a word holds a cell) and the inverse.  The mark sets bits
// where the batch's ids are, the rank scan reads only the words the
// summary marks, and the unmark clears only those, so a sort's fixed
// cost follows the batch, not the grid: the scan's other work is a
// summary bit a 32 cells.
//
// What holds it on the card (the tsdf512 batch, H100): the passes'
// latency, not their bytes.  A pass tile lives ~10-13 us (its loads, the
// ranking, the tile scan and shared-memory placing, the look-back, the
// stores), three CTAs an SM (PERF.md §6).
//
// Design: a memset of the batch's scratch and 4 + passes launches, no
// host read (launch_tsdf_sort):
//  0. one cudaMemsetAsync zeroes the scratch: D and the pass count, the
//     passes' tile counters, the digit histograms, the rank scan's
//     look-back and the passes' tile status words;
//  1. mark (t5_mark_kernel), a warp 256 lanes at a time: each valid lane
//     that starts a run of equal ids among the warp's 32 (neighbouring
//     pixels mostly share a cell) sets its id's bit, with an atomicOr only
//     where the word lacks the bit; the lane that finds the word empty
//     sets the word's summary bit; lanes out of range are counted;
//  2. rank (t5_rank_kernel): the exclusive scan of the bitmap words'
//     popcounts with decoupled look-back (scan.cuh), each word read only
//     where its summary bit is set, writes each marked word's prefix, so
//     that rank(id) = prefix[id >> 5] + popc(word & bits below id); its
//     last tile writes D and the pass count, and adds one batch and the
//     passes into the caller's counts;
//  3. histogram (t5_hist_kernel), a thread T5_SWEEP_ITEMS consecutive
//     lanes at a time: each run of equal ids among them looks its rank up
//     once and adds its length to each pass's digit in shared memory;
//     each lane's rank is written where the first pass reads it; then the
//     block's counts go into the batch's digit histograms;
//  4. unmark (t5_unmark_kernel), a warp 32 summary words at a time: each
//     marked word's ids written into the inverse at their ranks, the word
//     and its summary cleared;
//  5. the passes (t5_pass_kernel), persistent CTAs (T5_PASS_CTAS an SM)
//     that take tiles of T5_TILE lanes in order from a counter: load the
//     tile's ranks and lane indices (the first pass: the lanes' own
//     indices), each rank's digit; rank each lane among its warp's lanes
//     of the same digit in lane order (__match_any_sync, a running count
//     a warp and digit in shared memory); a thread a digit: the digit's
//     count before each warp and in the tile, the tile's count published
//     (one 64-bit status word a tile and digit carrying the pass in its
//     tag, so one memset serves every pass), the tile's pairs put in digit
//     order in shared memory; then the counts of the tiles before it read
//     back (decoupled look-back, T5_LOOKBACK tiles a round trip), the
//     digit's place in the batch from its histogram, and the pairs written
//     out in digit order, each digit's lanes consecutive.  A pass writes
//     into the output pair (sid, order) or into the alternate pair, so
//     that the last pass the batch needs writes the output, and reads the
//     other pair: the histogram put the ranks in that pair's first half
//     for the first pass.  The last pass writes ids, not ranks.

#include "scan.cuh"

constexpr int T5_ITEMS = 16;                    // lanes a thread, a pass
constexpr int T5_TILE = T5_ITEMS * SCAN_THREADS;
constexpr int T5_RADIX = 256;
constexpr int T5_MAX_PASSES = 4;
constexpr int T5_SWEEP_ITEMS = 8;               // lanes a thread, mark/hist
constexpr int T5_LOOKBACK = 4;                  // tiles a look-back round
constexpr int T5_PASS_CTAS = 3;                 // CTAs an SM, a pass
constexpr int T5_INV_CAP = 1 << 22;             // most entries of the inverse
static_assert(SCAN_THREADS == T5_RADIX, "a thread a digit");
static_assert(T5_SWEEP_ITEMS == 8, "the ranks are stored as two int4");

// tile status words: the count in the low 32 bits, a flag, the pass + 1
constexpr unsigned long long T5_AGG = 1ull << 32;
constexpr unsigned long long T5_INCL = 1ull << 33;
constexpr int T5_TAG_SHIFT = 40;

// The scratch, in ints from an 8-byte aligned start
// (kernels/__init__.py tsdf_sort_words): D, the pass count, two pads,
// the passes' tile counters (64-bit); the digit histograms of the
// passes; the rank scan's look-back; the passes' tile status words.
struct T5Layout {
    long hist, lookback, status, words;
};

static inline T5Layout t5_layout(long M, long n_cells) {
    T5Layout l;
    const long W = (n_cells + 31) / 32;
    l.hist = 4 + 2 * T5_MAX_PASSES;
    l.lookback = l.hist + T5_MAX_PASSES * T5_RADIX;
    l.status = l.lookback + lookback_words(W, RUN_SCAN_TILE);
    l.words = l.status + 2L * grid_blocks(M, T5_TILE) * T5_RADIX;
    return l;
}

// The tables, in ints (kernels/__init__.py tsdf_sort_tables): the bitmap
// (W words), its summary (W1 words), both zero between sorts; the
// words' prefixes (W); the inverse (C).
struct T5Tables {
    long W, W1, C, words;
};

static inline T5Tables t5_tables(long n_cells) {
    T5Tables t;
    t.W = (n_cells + 31) / 32;
    t.W1 = (t.W + 31) / 32;
    t.C = n_cells < T5_INV_CAP ? n_cells : T5_INV_CAP;
    t.words = 2 * t.W + t.W1 + t.C;
    return t;
}

// passes a rank key of at most D needs
__host__ __device__ __forceinline__ int t5_passes(long D) {
    return D < (1L << 8) ? 1 : D < (1L << 16) ? 2 : D < (1L << 24) ? 3 : 4;
}

// the dense rank of ``id``: D for an id outside [0, n_cells)
__device__ __forceinline__ int t5_rank(const unsigned* __restrict__ bits,
                                       const int* __restrict__ prefix,
                                       int n_cells, int D, int id) {
    if ((unsigned)id >= (unsigned)n_cells) return D;
    const int w = id >> 5;
    return __ldg(prefix + w)
           + __popc(__ldg(bits + w) & ((1u << (id & 31)) - 1u));
}

// T5_SWEEP_ITEMS consecutive lanes of a thread, their ids in id[]; the
// lanes past M hold INVALID_ID
__device__ __forceinline__ void t5_load_run(const int* __restrict__ skey,
                                            long M, long i0, int* id) {
    if (i0 + T5_SWEEP_ITEMS <= M
        && (reinterpret_cast<uintptr_t>(skey) & 15) == 0) {
#pragma unroll
        for (int q = 0; q < T5_SWEEP_ITEMS / 4; ++q) {
            const int4 v = __ldg(reinterpret_cast<const int4*>(skey + i0)
                                 + q);
            id[4 * q] = v.x;
            id[4 * q + 1] = v.y;
            id[4 * q + 2] = v.z;
            id[4 * q + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < T5_SWEEP_ITEMS; ++j)
            id[j] = i0 + j < M ? skey[i0 + j] : INVALID_ID;
    }
}

static __global__ void __launch_bounds__(SCAN_THREADS)
t5_mark_kernel(const int* __restrict__ skey, long M, int n_cells,
               unsigned* __restrict__ bits, unsigned* __restrict__ summary,
               unsigned long long* __restrict__ counts) {
    constexpr int CHUNK = 32 * T5_SWEEP_ITEMS;
    const int lane = threadIdx.x & 31;
    const long warps = (long)gridDim.x * SCAN_WARPS;
    int outside = 0;                    // lanes out of range, this lane's
    for (long base = ((long)blockIdx.x * SCAN_WARPS + (threadIdx.x >> 5))
                     * CHUNK;
         base < M; base += warps * CHUNK) {
        int id[T5_SWEEP_ITEMS];
#pragma unroll
        for (int k = 0; k < T5_SWEEP_ITEMS; ++k) {
            const long i = base + 32 * k + lane;
            id[k] = i < M ? skey[i] : INVALID_ID;
        }
#pragma unroll
        for (int k = 0; k < T5_SWEEP_ITEMS; ++k) {
            // the first lane of a run of equal ids sets the bit, and the
            // lane that finds its word empty the word's summary bit
            const int prev = __shfl_up_sync(FULL_MASK, id[k], 1);
            const bool in = (unsigned)id[k] < (unsigned)n_cells;
            outside += !in && id[k] != INVALID_ID;
            if (in && (lane == 0 || prev != id[k])) {
                unsigned* p = bits + (id[k] >> 5);
                const unsigned bit = 1u << (id[k] & 31);
                if ((*p & bit) == 0u && atomicOr(p, bit) == 0u)
                    atomicOr(summary + (id[k] >> 10),
                             1u << ((id[k] >> 5) & 31));
            }
        }
    }
    outside = __reduce_add_sync(FULL_MASK, outside);
    if (lane == 0 && outside)
        atomicAdd(counts + 2, (unsigned long long)outside);
}

static __global__ void __launch_bounds__(SCAN_THREADS)
t5_rank_kernel(const unsigned* __restrict__ bits,
               const unsigned* __restrict__ summary,
               int* __restrict__ prefix, long W, int tiles,
               int* __restrict__ meta,
               unsigned long long* __restrict__ counts,
               int* __restrict__ lb_scratch) {
    const LookBack lb(lb_scratch, tiles);
    const int tile = next_tile(lb.counter);
    // a warp's 32 words of a round share one summary word (i & 31 is the
    // lane), so the summary is one broadcast load
    const long base = (long)tile * RUN_SCAN_TILE + threadIdx.x;
    unsigned w[RUN_SCAN_ITEMS];
    int v[RUN_SCAN_ITEMS];
#pragma unroll
    for (int k = 0; k < RUN_SCAN_ITEMS; ++k) {
        const long i = base + k * SCAN_THREADS;
        const unsigned s = i < W ? __ldg(summary + (i >> 5)) : 0u;
        w[k] = (s >> (i & 31)) & 1u ? __ldg(bits + i) : 0u;
        v[k] = __popc(w[k]);
    }
    const int agg = tile_scan(SumOp(), v);
    const int before = tile_prefix(lb, tile, agg);
#pragma unroll
    for (int k = 0; k < RUN_SCAN_ITEMS; ++k) {
        const long i = base + k * SCAN_THREADS;
        if (w[k]) prefix[i] = before + v[k] - __popc(w[k]);
    }
    if (tile == tiles - 1 && threadIdx.x == 0) {
        const int D = before + agg;
        const int P = t5_passes(D);
        meta[0] = D;
        meta[1] = P;
        atomicAdd(counts, 1ull);
        atomicAdd(counts + 1, (unsigned long long)P);
    }
}

static __global__ void __launch_bounds__(SCAN_THREADS)
t5_hist_kernel(const int* __restrict__ skey, long M, int n_cells,
               const unsigned* __restrict__ bits,
               const int* __restrict__ prefix, const int* __restrict__ meta,
               int* __restrict__ hist, int* __restrict__ out_k,
               int* __restrict__ alt_k) {
    __shared__ int h[T5_MAX_PASSES * T5_RADIX];
    for (int j = threadIdx.x; j < T5_MAX_PASSES * T5_RADIX;
         j += SCAN_THREADS)
        h[j] = 0;
    __syncthreads();
    const int D = meta[0], P = meta[1];
    // the pair the first pass reads: the one the last pass does not write
    int* rank = (P & 1) ? alt_k : out_k;
    const bool vec = (reinterpret_cast<uintptr_t>(rank) & 15) == 0;
    const long stride = (long)gridDim.x * SCAN_THREADS * T5_SWEEP_ITEMS;
    for (long i0 = ((long)blockIdx.x * SCAN_THREADS + threadIdx.x)
                   * T5_SWEEP_ITEMS;
         i0 < M; i0 += stride) {
        int id[T5_SWEEP_ITEMS];
        t5_load_run(skey, M, i0, id);
        // each run of equal ids among the thread's lanes looked up and
        // counted at its last lane, then its rank given to its other lanes
        bool end[T5_SWEEP_ITEMS];
        int r[T5_SWEEP_ITEMS];
#pragma unroll
        for (int j = 0; j < T5_SWEEP_ITEMS; ++j)
            end[j] = j + 1 == T5_SWEEP_ITEMS || id[j + 1] != id[j]
                     || i0 + j + 1 >= M;
        int n = 1;
#pragma unroll
        for (int j = 0; j < T5_SWEEP_ITEMS; ++j) {
            r[j] = 0;
            if (!end[j]) {
                ++n;
                continue;
            }
            if (i0 + j < M) {
                r[j] = t5_rank(bits, prefix, n_cells, D, id[j]);
                for (int p = 0; p < P; ++p)
                    atomicAdd(&h[p * T5_RADIX + ((r[j] >> (8 * p)) & 255)],
                              n);
            }
            n = 1;
        }
#pragma unroll
        for (int j = T5_SWEEP_ITEMS - 2; j >= 0; --j)
            if (!end[j]) r[j] = r[j + 1];
        if (vec && i0 + T5_SWEEP_ITEMS <= M) {
            int4* o = reinterpret_cast<int4*>(rank + i0);
            o[0] = make_int4(r[0], r[1], r[2], r[3]);
            o[1] = make_int4(r[4], r[5], r[6], r[7]);
        } else {
#pragma unroll
            for (int j = 0; j < T5_SWEEP_ITEMS; ++j)
                if (i0 + j < M) rank[i0 + j] = r[j];
        }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < P * T5_RADIX; j += SCAN_THREADS)
        if (h[j]) atomicAdd(hist + j, h[j]);
}

// a warp 32 summary words a round: the ids of each marked bitmap word
// written into the inverse at their ranks (those below C), the word and
// its summary cleared
static __global__ void __launch_bounds__(SCAN_THREADS)
t5_unmark_kernel(unsigned* __restrict__ bits, unsigned* __restrict__ summary,
                 const int* __restrict__ prefix, long W1,
                 int* __restrict__ inv, int C) {
    const int lane = threadIdx.x & 31;
    const long warps = (long)gridDim.x * SCAN_WARPS;
    for (long c = (long)blockIdx.x * SCAN_WARPS + (threadIdx.x >> 5);
         c * 32 < W1; c += warps) {
        const long q = c * 32 + lane;
        const unsigned s = q < W1 ? summary[q] : 0u;
        if (s) summary[q] = 0u;
        unsigned todo = __ballot_sync(FULL_MASK, s != 0u);
        while (todo) {
            const int src = __ffs(todo) - 1;
            todo &= todo - 1;
            const unsigned ss = __shfl_sync(FULL_MASK, s, src);
            if ((ss >> lane) & 1u) {
                const long w = ((c * 32 + src) << 5) + lane;
                unsigned b = bits[w];
                bits[w] = 0u;
                int r = prefix[w];
                while (b && r < C) {
                    inv[r++] = (int)(w << 5) + __ffs(b) - 1;
                    b &= b - 1;
                }
            }
        }
    }
}

// exclusive scans over the block's threads (thread t's a and b)
__device__ __forceinline__ void t5_exclusive2(int a, int b, int& ea,
                                              int& eb) {
    __shared__ int2 wsum[SCAN_WARPS];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    int ia = a, ib = b;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int ya = __shfl_up_sync(FULL_MASK, ia, d);
        const int yb = __shfl_up_sync(FULL_MASK, ib, d);
        if (lane >= d) {
            ia += ya;
            ib += yb;
        }
    }
    if (lane == 31) wsum[w] = make_int2(ia, ib);
    __syncthreads();
    int pa = 0, pb = 0;
#pragma unroll
    for (int v = 0; v < SCAN_WARPS; ++v) {
        if (v < w) {
            pa += wsum[v].x;
            pb += wsum[v].y;
        }
    }
    ea = pa + ia - a;
    eb = pb + ib - b;
}

static __global__ void __launch_bounds__(SCAN_THREADS, T5_PASS_CTAS)
t5_pass_kernel(int p, const int* __restrict__ skey, int* out_k, int* out_i,
               int* alt_k, int* alt_i, int M, const int* __restrict__ inv,
               int C, const int* __restrict__ meta,
               const int* __restrict__ hist,
               unsigned long long* __restrict__ counters,
               unsigned long long* __restrict__ status) {
    const int P = meta[1];
    if (p >= P) return;                 // the batch needs no such pass
    const int D = meta[0];
    // the last pass writes the output pair, the ones before alternate;
    // each pass reads the other pair (the first: the ranks the histogram
    // put there, and the lanes' own indices)
    const bool to_out = ((P - 1 - p) & 1) == 0;
    const bool last = p == P - 1;
    int* dk = to_out ? out_k : alt_k;
    int* di = to_out ? out_i : alt_i;
    const int* sk = to_out ? alt_k : out_k;
    const int* si = to_out ? alt_i : out_i;
    const int shift = 8 * p;

    // whist[w][d]: warp w's lanes of digit d, then those before warp w
    __shared__ int whist[SCAN_WARPS][T5_RADIX];
    __shared__ int keys_s[T5_TILE];
    __shared__ int vals_s[T5_TILE];
    __shared__ unsigned char dig_s[T5_TILE];
    __shared__ int tstart_s[T5_RADIX];  // the digit's first place in tile
    __shared__ int gdelta_s[T5_RADIX];  // its place in the batch, less that
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int tiles = (M + T5_TILE - 1) / T5_TILE;
    for (;;) {
        for (int j = tid; j < SCAN_WARPS * T5_RADIX; j += SCAN_THREADS)
            (&whist[0][0])[j] = 0;
        const int tile = next_tile(counters + p);      // syncs the block
        if (tile >= tiles) break;
        const int tbase = tile * T5_TILE;
        const int tn = min(T5_TILE, M - tbase);
        const int wbase = tbase + w * 32 * T5_ITEMS;

        int key[T5_ITEMS], val[T5_ITEMS], dig[T5_ITEMS];
#pragma unroll
        for (int k = 0; k < T5_ITEMS; ++k) {
            const int i = wbase + 32 * k + lane;
            key[k] = i < M ? sk[i] : 0;
            val[k] = i < M ? (p == 0 ? i : si[i]) : 0;
            dig[k] = i < M ? (key[k] >> shift) & 255 : T5_RADIX;
        }
        // each lane's place among its warp's lanes of its digit, in lane
        // order: its peers of the same digit, the count before them from the
        // warp's running count, which their last lane advances; the place
        // goes into dig's high bits
        const unsigned lt = (1u << lane) - 1u;
#pragma unroll
        for (int k = 0; k < T5_ITEMS; ++k) {
            const bool real = dig[k] < T5_RADIX;
            const unsigned peers = __match_any_sync(FULL_MASK, dig[k]);
            const int lastp = 31 - __clz(peers);
            int before = 0;
            if (real && lane == lastp) {
                before = whist[w][dig[k]];
                whist[w][dig[k]] = before + __popc(peers);
            }
            before = __shfl_sync(FULL_MASK, before, lastp);
            __syncwarp();
            dig[k] |= (before + __popc(peers & lt)) << 9;
        }
        __syncthreads();

        // thread d: digit d's lanes before each warp and in the tile, the
        // tile's count published, the digit's first place in the tile
        const int d = tid;
        int cnt = 0;
#pragma unroll
        for (int v = 0; v < SCAN_WARPS; ++v) {
            const int c = whist[v][d];
            whist[v][d] = cnt;
            cnt += c;
        }
        const unsigned long long tag = (unsigned long long)(p + 1)
                                       << T5_TAG_SHIFT;
        unsigned long long* st = status + (long)tile * T5_RADIX + d;
        store_relaxed(st,
                      tag | (tile == 0 ? T5_INCL : T5_AGG) | (unsigned)cnt);
        int dstart, tstart;
        t5_exclusive2(hist[p * T5_RADIX + d], cnt, dstart, tstart);
        tstart_s[d] = tstart;
        __syncthreads();

        // the tile's pairs in digit order in shared memory
#pragma unroll
        for (int k = 0; k < T5_ITEMS; ++k) {
            const int dk_ = dig[k] & 511;
            if (dk_ < T5_RADIX) {
                const int pos = tstart_s[dk_] + whist[w][dk_] + (dig[k] >> 9);
                keys_s[pos] = key[k];
                vals_s[pos] = val[k];
                dig_s[pos] = (unsigned char)dk_;
            }
        }

        // then digit d's lanes in the tiles before (decoupled look-back),
        // T5_LOOKBACK predecessors a round trip, nearest first: their counts
        // up to the nearest inclusive one, or up to the nearest not yet
        // published in this pass, where the next round starts
        int excl = 0;
        if (tile > 0) {
            for (int t = tile - 1;;) {
                unsigned long long s[T5_LOOKBACK];
#pragma unroll
                for (int j = 0; j < T5_LOOKBACK; ++j)
                    s[j] = t - j >= 0 ? load_relaxed(status
                                                     + (long)(t - j) * T5_RADIX
                                                     + d)
                                      : 0ull;
                int add = 0, used = 0;
                bool stop = false, found = false;
#pragma unroll
                for (int j = 0; j < T5_LOOKBACK; ++j) {
                    if (stop) continue;
                    if ((s[j] >> T5_TAG_SHIFT) != (unsigned)(p + 1)) {
                        stop = true;
                        continue;
                    }
                    add += (int)(unsigned)s[j];
                    used = j + 1;
                    found = stop = (s[j] & T5_INCL) != 0;
                }
                excl += add;
                if (found) break;
                t -= used;
                if (used < T5_LOOKBACK) __nanosleep(32);
            }
            store_relaxed(st, tag | T5_INCL | (unsigned)(excl + cnt));
        }
        gdelta_s[d] = dstart + excl - tstart;
        __syncthreads();

        // out in digit order, each digit's run of lanes to consecutive
        // places; the last pass turns each rank back into its id
        if (!last) {
            for (int i = tid; i < tn; i += SCAN_THREADS) {
                const int g = gdelta_s[dig_s[i]] + i;
                dk[g] = keys_s[i];
                di[g] = vals_s[i];
            }
        } else if (D < C) {
            for (int i = tid; i < tn; i += SCAN_THREADS) {
                const int g = gdelta_s[dig_s[i]] + i;
                const int r = keys_s[i];
                dk[g] = r < D ? __ldg(inv + r) : INVALID_ID;
                di[g] = vals_s[i];
            }
        } else {
            for (int i = tid; i < tn; i += SCAN_THREADS) {
                const int g = gdelta_s[dig_s[i]] + i;
                dk[g] = __ldg(skey + vals_s[i]);
                di[g] = vals_s[i];
            }
        }
        __syncthreads();                // the next tile reuses the smem
    }
}

// the CTAs of a launch that takes ``per`` items a CTA, at most ``ctas``
// a streaming multiprocessor
static int t5_blocks(long n, long per, int ctas) {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long need = (n + per - 1) / per;
    return (int)(need < (long)ctas * sms ? (need < 1 ? 1 : need)
                                         : (long)ctas * sms);
}

// The sort of M ids in [0, n_cells) or INVALID_ID into sid and order (M
// ints each), through the alternate pair alt_k / alt_i (M ints each);
// ``scratch`` holds tsdf_sort_words(M, n_cells) ints, 8-byte aligned;
// ``tables`` tsdf_sort_tables(n_cells) ints, the first W + W1 zero, as
// the sort leaves them; ``counts`` three i64, [batches sorted, passes
// run, lanes out of range], added to on the card.
extern "C" int launch_tsdf_sort(const void* skey, int M, int n_cells,
                                void* sid, void* order, void* alt_k,
                                void* alt_i, void* scratch, long words,
                                void* tables, long table_words,
                                void* counts, void* stream) {
    const T5Layout l = t5_layout(M, n_cells);
    const T5Tables t = t5_tables(n_cells);
    if (words < l.words || table_words < t.words || n_cells <= 0 || M < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    int* sc = (int*)scratch;
    const cudaError_t e =
        cudaMemsetAsync(sc, 0, l.words * sizeof(int), st);
    if (e != cudaSuccess) return (int)e;
    if (M == 0) return 0;
    unsigned* bits = (unsigned*)tables;
    unsigned* summary = bits + t.W;
    int* prefix = (int*)(summary + t.W1);
    int* inv = prefix + t.W;
    unsigned long long* cnt = (unsigned long long*)counts;
    const int blocks = t5_blocks(M, SCAN_THREADS * T5_SWEEP_ITEMS, 8);
    t5_mark_kernel<<<blocks, SCAN_THREADS, 0, st>>>((const int*)skey, M,
                                                    n_cells, bits, summary,
                                                    cnt);
    const int wtiles = grid_blocks(t.W, RUN_SCAN_TILE);
    t5_rank_kernel<<<wtiles, SCAN_THREADS, 0, st>>>(
        bits, summary, prefix, t.W, wtiles, sc, cnt, sc + l.lookback);
    t5_hist_kernel<<<blocks, SCAN_THREADS, 0, st>>>(
        (const int*)skey, M, n_cells, bits, prefix, sc, sc + l.hist,
        (int*)sid, (int*)alt_k);
    t5_unmark_kernel<<<t5_blocks(t.W1, 32 * SCAN_WARPS, 8), SCAN_THREADS,
                       0, st>>>(bits, summary, prefix, t.W1, inv, (int)t.C);
    const int ctas = t5_blocks(M, T5_TILE, T5_PASS_CTAS);
    const int passes = t5_passes(M < n_cells ? M : n_cells);
    for (int p = 0; p < passes; ++p)
        t5_pass_kernel<<<ctas, SCAN_THREADS, 0, st>>>(
            p, (const int*)skey, (int*)sid, (int*)order, (int*)alt_k,
            (int*)alt_i, M, inv, (int)t.C, sc, sc + l.hist,
            (unsigned long long*)(sc + 4),
            (unsigned long long*)(sc + l.status));
    return (int)cudaGetLastError();
}
