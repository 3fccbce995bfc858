// Kernel K2: batched hash find-or-insert of distinct cell ids.
//
// Replaces: hifi_fusion_tpu/ops/hashing.py lookup_or_insert and its staged
// lookup (:80-298).  There, insertion is a per-round sort election
// followed by one unique-index scatter, because duplicate-index scatters
// serialize on a TPU.  Here each id probes on its own and claims an empty
// slot with atomicCAS.
//
// Bound on the card: latency of dependent random loads.  Each probe is one
// scattered 4 B load; the bench's 2^22-slot key table (16 MB) fits in the
// 50 MB L2, so probes mostly hit L2.  At ~1-3 probes per id and up to
// ~1.8 M ids per call (refine's line cells) that is a few million
// scattered accesses, far below any bandwidth limit.
//
// Design: one thread per id.  Thread i probes (fmix32(id) + j(j+1)/2) &
// (C-1) for j < max_probes (the JAX package's triangular sequence, which
// visits every slot of a power-of-two table).  It stops at its own id, or
// at an empty slot it claims with atomicCAS(-1 -> id); a lost CAS returns
// the winner's id, which is re-checked (it is never the thread's own id,
// since the ids are distinct) and the probe continues.  An id still
// unplaced after max_probes gets slot -1 and counts in n_failed.  Slots
// may differ from the JAX package's lane-order election; callers compare
// by cell id.

#include "common.cuh"

__global__ void hash_insert_kernel(int* __restrict__ keys,
                                   const int* __restrict__ ids, int n,
                                   uint32_t mask, int max_probes,
                                   int* __restrict__ slots,
                                   int* __restrict__ n_failed) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int id = ids[i];
    const uint32_t h = fmix32((uint32_t)id);
    for (uint32_t j = 0; j < (uint32_t)max_probes; ++j) {
        const int s = (int)((h + ((j * (j + 1u)) >> 1)) & mask);
        int k = ((volatile int*)keys)[s];
        if (k == -1) k = atomicCAS(keys + s, -1, id);
        if (k == -1 || k == id) {
            slots[i] = s;
            return;
        }
    }
    slots[i] = -1;
    atomicAdd(n_failed, 1);
}

extern "C" int launch_hash_insert(void* keys, const void* ids, int n,
                                  int capacity, int max_probes, void* slots,
                                  void* n_failed, void* stream) {
    if (n == 0) return 0;
    const int threads = 256;
    hash_insert_kernel<<<grid_blocks(n, threads), threads, 0,
                         (cudaStream_t)stream>>>(
        (int*)keys, (const int*)ids, n, (uint32_t)(capacity - 1),
        max_probes, (int*)slots, (int*)n_failed);
    return (int)cudaGetLastError();
}
