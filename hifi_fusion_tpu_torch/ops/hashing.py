"""Open-addressing spatial hash: fmix32, triangular probing, find-or-insert.

The counterpart of ``hifi_fusion_tpu/ops/hashing.py``.  Keys are dense
int32 cell ids in a power-of-two key table (``-1`` = empty).  A cell id
probes ``(fmix32(id) + j(j+1)/2) & (C-1)`` for ``j < max_probes``; an id
that finds neither itself nor an empty slot within the bound is dropped and
counted (the caller adds the count to ``overflow_probe``).

``lookup_or_insert`` is kernel K2 (``csrc/hash_insert.cu``) on a CUDA
tensor and its plain version on a CPU tensor.  Either may assign other
slots than the JAX package's lane-order election; every comparison is by
cell id.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 ``h`` in [0, 2^32), without int64
    overflow: the constant is split into 16-bit halves."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 of int32 ids, as int64 values in [0, 2^32)."""
    h = x.to(torch.int64) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def probe_offset(j: int) -> int:
    """Triangular probe offset j(j+1)/2: visits every slot of a
    power-of-two table once over C probes."""
    return (j * (j + 1)) >> 1


def lookup(key_table: torch.Tensor, ids: torch.Tensor, max_probes: int,
           capacity: int) -> torch.Tensor:
    """Slots holding ``ids`` (-1 = absent).  Plain PyTorch on any device;
    an id stops at itself or at the first empty slot."""
    h0 = hash_u32(ids)
    slot = torch.full_like(ids, -1)
    pending = torch.arange(ids.numel(), device=ids.device)
    for j in range(max_probes):
        if pending.numel() == 0:
            break
        cand = (h0[pending] + probe_offset(j)) & (capacity - 1)
        tk = key_table[cand]
        found = tk == ids[pending]
        slot[pending[found]] = cand[found].to(slot.dtype)
        pending = pending[~found & (tk != -1)]
    return slot


def insert_plain(key_table, ids, max_probes, capacity):
    """Plain version of K2: the same probe sequence, one round per probe
    index over the unresolved ids."""
    h0 = hash_u32(ids)
    slot = torch.full_like(ids, -1)
    pending = torch.arange(ids.numel(), device=ids.device)
    for j in range(max_probes):
        if pending.numel() == 0:
            break
        cand = (h0[pending] + probe_offset(j)) & (capacity - 1)
        tk = key_table[cand]
        found = tk == ids[pending]
        slot[pending[found]] = cand[found].to(slot.dtype)
        # among ids meeting one empty slot, the first in input order wins
        empty = torch.nonzero(tk == -1).squeeze(1)
        sc, order = torch.sort(cand[empty], stable=True)
        first = torch.ones_like(sc, dtype=torch.bool)
        first[1:] = sc[1:] != sc[:-1]
        win = empty[order[first]]
        key_table[cand[win]] = ids[pending[win]]
        slot[pending[win]] = cand[win].to(slot.dtype)
        found[win] = True
        pending = pending[~found]
    n_failed = torch.tensor(pending.numel(), dtype=torch.int32,
                            device=ids.device)
    return slot, n_failed


def lookup_or_insert(key_table: torch.Tensor, ids: torch.Tensor,
                     max_probes: int, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Find-or-insert DISTINCT int32 ``ids`` (both callers deduplicate
    first).  Updates ``key_table`` in place and returns ``(slot, n_failed)``:
    a slot per id, -1 for an id that exhausted ``max_probes``, and the
    number of such ids as a 0-d int32 tensor."""
    if key_table.dtype != torch.int32 or ids.dtype != torch.int32:
        raise TypeError("key_table and ids must be int32")
    if key_table.dim() != 1 or key_table.numel() != capacity \
            or not key_table.is_contiguous():
        raise ValueError("key_table must be a contiguous (capacity,) table")
    if ids.device != key_table.device:
        raise ValueError("ids and key_table must share a device")
    if key_table.device.type == "cpu":
        return insert_plain(key_table, ids, max_probes, capacity)
    if key_table.device.type != "cuda":
        raise ValueError(f"unsupported device {key_table.device}")
    ids = ids.contiguous()
    n = ids.numel()
    slot = torch.empty(n, dtype=torch.int32, device=ids.device)
    n_failed = torch.zeros((), dtype=torch.int32, device=ids.device)
    if n == 0:
        return slot, n_failed
    lib = kernels.library()
    kernels.check(lib.launch_hash_insert(
        key_table.data_ptr(), ids.data_ptr(), n, capacity, max_probes,
        slot.data_ptr(), n_failed.data_ptr(), kernels.stream()),
        "hash_insert")
    kernels.LAUNCHES["hash_insert"] += 1
    return slot, n_failed
