"""Open-addressing spatial hash: fmix32, triangular probing, find-or-insert.

The counterpart of ``hifi_fusion_tpu/ops/hashing.py``.  Keys are dense
int32 cell ids in a power-of-two key table (``-1`` = empty).  A cell id
probes ``(fmix32(id) + j(j+1)/2) & (C-1)`` for ``j < max_probes``; an id
that finds neither itself nor an empty slot within the bound is dropped and
counted: into the caller's ``overflow_probe`` counter where it passes one,
else in a returned count.

``lookup_or_insert`` is kernel K2 (``csrc/hash_insert.cu``) on a CUDA
tensor and its plain version on a CPU tensor.  Either may assign other
slots than the JAX package's lane-order election; every comparison is by
cell id.  A caller whose id count stays on the card hands K2 an array
sized by its lane budget with its ids packed first and their count as a
device int (``n_live``; the integrate's run ids and the refine's line
cells).  A lane holding ``INVALID_ID`` (INT32_MAX, never a cell id) has no
id: it gets slot -1 and is not counted as a failure.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .. import kernels

_M32 = 0xFFFFFFFF
INVALID_ID = torch.iinfo(torch.int32).max   # a lane without an id


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


def insert_plain(key_table, ids, max_probes, capacity, overflow=None,
                 n_live=None):
    """Plain version of K2: the same probe sequence, one round per probe
    index over the unresolved ids (``INVALID_ID`` lanes and lanes at or
    past ``n_live`` are never pending, and get -1).  Returns what
    ``lookup_or_insert`` returns."""
    h0 = hash_u32(ids)
    slot = torch.full_like(ids, -1)
    live = ids != INVALID_ID
    if n_live is not None:
        live[int(n_live):] = False
    pending = torch.nonzero(live).squeeze(1)
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
    if overflow is not None:
        overflow += pending.numel()
        return slot
    return slot, torch.tensor(pending.numel(), dtype=torch.int32,
                              device=ids.device)


def lookup_or_insert(key_table: torch.Tensor, ids: torch.Tensor,
                     max_probes: int, capacity: int,
                     overflow: Optional[torch.Tensor] = None,
                     n_live: Optional[torch.Tensor] = None
                     ) -> Union[torch.Tensor,
                                Tuple[torch.Tensor, torch.Tensor]]:
    """Find-or-insert DISTINCT int32 ``ids`` (every caller deduplicates
    first); ``INVALID_ID`` lanes, any number of them, hold no id.  Updates
    ``key_table`` in place and gives a slot per lane, -1 for an id that
    exhausted ``max_probes`` and for an ``INVALID_ID`` lane.  With
    ``n_live``, a 0-d int32 count on the table's device, only the lanes
    before it are ids: the kernel neither reads nor writes the rest (their
    slots are left unset), the plain version gives them -1.  With
    ``overflow``, the caller's 0-d int32 counter, the number of ids that
    failed is added into it in place and the slots alone are returned
    (one launch on the card);
    without it, ``(slot, n_failed)`` with the number as a 0-d int32
    tensor."""
    if key_table.dtype != torch.int32 or ids.dtype != torch.int32:
        raise TypeError("key_table and ids must be int32")
    if key_table.dim() != 1 or key_table.numel() != capacity \
            or not key_table.is_contiguous():
        raise ValueError("key_table must be a contiguous (capacity,) table")
    if ids.device != key_table.device:
        raise ValueError("ids and key_table must share a device")
    for name, c in (("overflow", overflow), ("n_live", n_live)):
        if c is not None and (c.dtype != torch.int32 or c.dim() != 0
                              or c.device != key_table.device):
            raise ValueError(f"{name} must be a 0-d int32 tensor on the "
                             "table's device")
    if key_table.device.type == "cpu":
        return insert_plain(key_table, ids, max_probes, capacity, overflow,
                            n_live)
    if key_table.device.type != "cuda":
        raise ValueError(f"unsupported device {key_table.device}")
    ids = ids.contiguous()
    n = ids.numel()
    slot = torch.empty(n, dtype=torch.int32, device=ids.device)
    n_failed = overflow if overflow is not None else torch.zeros(
        (), dtype=torch.int32, device=ids.device)
    if n:
        lib = kernels.library()
        kernels.check(lib.launch_hash_insert(
            key_table.data_ptr(), ids.data_ptr(), n,
            None if n_live is None else n_live.data_ptr(), capacity,
            max_probes, slot.data_ptr(), n_failed.data_ptr(),
            kernels.stream()), "hash_insert")
        kernels.LAUNCHES["hash_insert"] += 1
    return slot if overflow is not None else (slot, n_failed)
