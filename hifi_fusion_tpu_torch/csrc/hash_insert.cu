// Kernel K2: batched hash find-or-insert of distinct cell ids.
//
// Replaces: hifi_fusion_tpu/ops/hashing.py lookup_or_insert and its staged
// lookup (:80-298).  There, insertion is a per-round sort election
// followed by one unique-index scatter, because duplicate-index scatters
// serialize on a TPU.  Here each id probes on its own and claims an empty
// slot with atomicCAS.
//
// Bound on the card: latency and rate of scattered accesses, not bytes.
// Three call shapes (PERF.md): the fusion integrate's ~149 k ids
// into a 2^22-slot table (16 MB), the refine's ~65 k line cells into the
// same table, and the TSDF batch's ~1.24 M ids into a 2^24-slot table
// (64 MB, more than the 50 MB L2), each at a load factor of 0.08-0.14,
// so nearly every id ends at its first probe; 95% of the TSDF ids and
// 96% of the integrate's are already in the table.  The small
// shapes are a chain of dependent round trips; the TSDF shape is ~1.2 M
// random HBM sectors.
//
// Design: one thread per id and one launch a call.  Thread i probes
// (fmix32(id) + j(j+1)/2) & (C-1) for j < max_probes (the JAX package's
// triangular sequence, which visits every slot of a power-of-two table).
// It loads the slot from L2 (a key, once set, never changes, so a stale
// -1 is the only stale value and the CAS corrects it) and stops at its
// own id; at an empty slot it claims it with atomicCAS(-1 -> id), and a
// lost CAS returns the winner's id (never its own: the ids are distinct)
// and the probe continues.  So an id stops at itself or claims the first
// empty slot in probe order.  A CAS straight on each probe slot saves a
// trip for a new id but, as an atomic, costs far more than a load where
// the id is already there (PERF.md).  The ids are read and the slots
// written with streaming hints, so that they do not push the table out of
// L2 (worth ~1% at the TSDF shape).  An id still unplaced after
// max_probes gets slot -1; each block adds its count of those into the
// caller's overflow counter with one atomic, and only when it is not 0,
// so no fill or add launch follows.  Callers whose id count lives on the
// card hand K2 arrays sized by their budgets, in one of two forms, so the
// host never reads the count: B3 passes its run count (n_live, a device
// int) and its ids packed before it, and the lanes at or past it are
// neither read nor written (their slots are left as they were; a block
// wholly past it returns at once); the refine's line cells (B6) pass the
// sorted lanes with INVALID_ID (INT32_MAX, never a cell id) in every lane
// that is not a run's first, and such a lane has no id: it gets slot -1
// and is not counted.
// Slots may differ from the JAX package's lane-order election; callers
// compare by cell id.

#include "common.cuh"

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
hash_insert_kernel(int* __restrict__ keys, const int* __restrict__ ids,
                   int n, const int* __restrict__ n_live, uint32_t mask,
                   int max_probes, int* __restrict__ slots,
                   int* __restrict__ n_failed) {
    const int i = blockIdx.x * kThreads + threadIdx.x;
    const int live = n_live != nullptr ? min(n, *n_live) : n;
    if (blockIdx.x * kThreads >= live) return;      // the whole block past it
    int failed = 0;
    if (i < live) {
        const int id = __ldcs(ids + i);
        const uint32_t h = fmix32((uint32_t)id);
        int slot = -1;
        for (uint32_t j = 0; id != INVALID_ID && j < (uint32_t)max_probes;
             ++j) {
            const int s = (int)((h + ((j * (j + 1u)) >> 1)) & mask);
            int k = __ldcg(keys + s);
            if (k == -1) k = atomicCAS(keys + s, -1, id);
            if (k == -1 || k == id) {
                slot = s;
                break;
            }
        }
        __stcs(slots + i, slot);
        failed = slot < 0 && id != INVALID_ID;
    }
    const int block_failed = __syncthreads_count(failed);
    if (threadIdx.x == 0 && block_failed != 0)
        atomicAdd(n_failed, block_failed);
}

// n_live: a device int bounding the lanes, or null for all n
extern "C" int launch_hash_insert(void* keys, const void* ids, int n,
                                  const void* n_live, int capacity,
                                  int max_probes, void* slots,
                                  void* n_failed, void* stream) {
    if (n == 0) return 0;
    hash_insert_kernel<<<grid_blocks(n, kThreads), kThreads, 0,
                         (cudaStream_t)stream>>>(
        (int*)keys, (const int*)ids, n, (const int*)n_live,
        (uint32_t)(capacity - 1), max_probes, (int*)slots, (int*)n_failed);
    return (int)cudaGetLastError();
}
