"""Spatial-hash neighbourhood queries over the fused grid (BASELINE config 4).

The counterpart of ``hifi_fusion_tpu/ops/queries.py``, with its semantics:

* ``occupied_neighbor_counts(grid, query_slots, config, radius_cells=2)``:
  per queried slot, the occupied cells of the (2r+1)^3 window around its
  voxel, the voxel itself included; a slot of -1 counts 0.  Kernel B11
  (``csrc/neighbor_count.cu``) on CUDA tensors, reading the window from the
  occupancy bitmap; its plain version on CPU tensors, in the JAX package's
  form (a hash lookup per window cell, chunked over the queries);
* ``radius_outlier_mask(grid, config, radius_cells=2, min_neighbors=5)``:
  (C,) bool in slot layout, the occupied voxels whose window holds at least
  ``min_neighbors`` occupied cells besides themselves (PCL's radius outlier
  removal, which the reference links but never runs);
* ``query_points(grid, points, config)``: (3,Q) world points to their
  voxel's slot, occupancy, normal flag and cylinder count, one hash lookup
  a point (``ops/hashing.lookup``).

Slots are the port's; they differ from the JAX package's, so a comparison
maps every slot-valued result through ``grid.key``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..config import FusionConfig
from ..grid import GridState, count_at, occupied_at, occupied_slots
from . import geometry, hashing

MAX_RADIUS = 15          # a column's 2r+1 bits fit in two bitmap words
LOOKUP_LANES = 1 << 22   # window cells a chunk of the plain version looks up


def _window_offsets(r: int) -> np.ndarray:
    """(3,M) offsets of the (2r+1)^3 window, dx-major, dz fastest."""
    a = np.arange(-r, r + 1)
    return np.stack(np.meshgrid(a, a, a, indexing="ij"),
                    axis=-1).reshape(-1, 3).T.copy()


def _windows(grid: GridState, query_slots: torch.Tensor,
             config: FusionConfig, r: int):
    """Per chunk of the live (non-negative) query slots: their positions
    in ``query_slots``, the (3,M,q) coords of their windows (a slot past
    the table reads its last slot, as the JAX package clips it) and
    which of those lie inside the grid."""
    offs = torch.from_numpy(_window_offsets(r)).to(query_slots.device,
                                                   torch.int32)  # (3,M)
    live = torch.nonzero(query_slots >= 0).squeeze(1)
    step = max(1, LOOKUP_LANES // offs.shape[1])
    for i in range(0, live.numel(), step):
        q = live[i:i + step]
        s = query_slots[q].clamp(max=config.capacity - 1).long()
        nc = (geometry.id_to_coords(grid.key[s], config)[:, None, :]
              + offs[:, :, None])
        yield q, nc, geometry.valid_coords(nc, config)


def neighbor_counts_plain(grid: GridState, query_slots: torch.Tensor,
                          config: FusionConfig, radius_cells: int = 2
                          ) -> torch.Tensor:
    """The JAX package's form (queries.py:40-60): a hash lookup of every
    window cell inside the grid, counted where it has a slot and a
    point."""
    out = torch.zeros_like(query_slots)
    for q, nc, valid in _windows(grid, query_slots, config, radius_cells):
        slot = hashing.lookup(grid.key, geometry.cell_id(nc, config)[valid],
                              config.max_probes, config.capacity)
        occ = torch.zeros_like(valid)
        occ[valid] = (slot >= 0) & occupied_at(grid, slot.clamp(min=0))
        out[q] = occ.sum(dim=0, dtype=torch.int32)
    return out


def neighbor_counts_bitmap(grid: GridState, query_slots: torch.Tensor,
                           config: FusionConfig, radius_cells: int = 2
                           ) -> torch.Tensor:
    """What kernel B11 reads, in plain PyTorch: each window cell's bit of
    the cell-id-keyed occupancy bitmap.  Equal to the lookup form, because
    a cell's bit is set exactly when it is placed and gets its first
    point; the tests hold the two to each other."""
    out = torch.zeros_like(query_slots)
    for q, nc, valid in _windows(grid, query_slots, config, radius_cells):
        nid = torch.where(valid, geometry.cell_id(nc, config),
                          torch.zeros_like(valid, dtype=torch.int32))
        words = grid.occ_bits[(nid >> 5).long()]
        bit = ((words >> (nid & 31)) & 1) != 0
        out[q] = (valid & bit).sum(dim=0, dtype=torch.int32)
    return out


def occupied_neighbor_counts(grid: GridState, query_slots: torch.Tensor,
                             config: FusionConfig, radius_cells: int = 2
                             ) -> torch.Tensor:
    """(Q,) int32 occupied cells in the (2r+1)^3 window around each query
    slot's voxel, itself included; a slot of -1 counts 0.  Kernel B11 on
    CUDA tensors, its plain version on CPU tensors; equal counts."""
    dev = grid.device
    if query_slots.dtype != torch.int32 or query_slots.dim() != 1 \
            or query_slots.device != dev \
            or not query_slots.is_contiguous():
        raise ValueError(f"query_slots must be a contiguous (Q,) int32 "
                         f"tensor on {dev}")
    if not 0 <= radius_cells <= MAX_RADIUS:
        raise ValueError(f"radius_cells must lie in [0, {MAX_RADIUS}]")
    if dev.type == "cpu":
        return neighbor_counts_plain(grid, query_slots, config, radius_cells)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    Q = query_slots.numel()
    out = torch.empty((Q,), dtype=torch.int32, device=dev)
    if Q:
        gf, gi = kernels.geometry_args(config)
        lib = kernels.library()
        kernels.check(lib.launch_neighbor_count(
            query_slots.data_ptr(), Q, grid.key.data_ptr(), config.capacity,
            grid.occ_bits.data_ptr(), grid.occ_bits.numel(),
            kernels.ptr(gf), kernels.ptr(gi), radius_cells, out.data_ptr(),
            kernels.stream()), "neighbor_count")
        kernels.LAUNCHES["neighbor_count"] += 1
    return out


def radius_outlier_mask(grid: GridState, config: FusionConfig,
                        radius_cells: int = 2,
                        min_neighbors: int = 5) -> torch.Tensor:
    """(C,) bool in slot layout: the occupied voxels with at least
    ``min_neighbors`` occupied cells in their window besides themselves."""
    C = config.capacity
    occ = occupied_slots(grid)
    slots = torch.where(occ, torch.arange(C, dtype=torch.int32,
                                          device=grid.device),
                        torch.full((), -1, dtype=torch.int32,
                                   device=grid.device))
    counts = occupied_neighbor_counts(grid, slots, config, radius_cells)
    return occ & ((counts - 1) >= min_neighbors)


class PointQuery(NamedTuple):
    slot: torch.Tensor          # (Q,) i32 voxel slot or -1
    occupied: torch.Tensor      # (Q,) bool
    normal_found: torch.Tensor  # (Q,) bool
    count: torch.Tensor         # (Q,) i32 cylinder hits of that voxel


def query_points(grid: GridState, points: torch.Tensor,
                 config: FusionConfig) -> PointQuery:
    """(3,Q) f32 world points -> their voxel's state; a point outside the
    grid, or in a cell the table does not hold, has slot -1."""
    C = config.capacity
    coords = geometry.cell_coords(points, config)
    valid = (geometry.valid_points(points, config)
             & geometry.valid_coords(coords, config))
    slot = torch.full(valid.shape, -1, dtype=torch.int32,
                      device=points.device)
    slot[valid] = hashing.lookup(grid.key,
                                 geometry.cell_id(coords, config)[valid],
                                 config.max_probes, C)
    safe = slot.clamp(0, C - 1)
    found = slot >= 0
    return PointQuery(
        slot=slot,
        occupied=found & occupied_at(grid, safe),
        normal_found=found & grid.normal_found[safe.long()],
        count=torch.where(found, count_at(grid, safe),
                          torch.zeros_like(slot)))
