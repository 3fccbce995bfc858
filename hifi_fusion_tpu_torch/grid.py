"""Grid state of the port: a dataclass of flat tensors on one device.

The counterpart of ``hifi_fusion_tpu/grid.py`` with the same fields and
layouts (slot-major flat per-voxel fields: ``normal`` (3C,), ``cyl_stats``
(5C,), ``dep`` (D*C,); planar ``buf_pts`` (3,B)), each sized to its live
region: the JAX package's scatter scratch tails do not exist here, because
PyTorch scatters take masked-out lanes by simply leaving them out.

``occ_bits`` holds the 32-cells-per-word occupancy bitmap as int32 bit
patterns: PyTorch's ``uint32`` lacks shifts and bitwise ops on several
backends.  ``convert.py`` reinterprets it with ``ndarray.view`` at the
boundary to the JAX package's u32 array.

The ops update a ``GridState`` in place (the JAX package's functions are
pure); in place saves copying the ~0.5 GB bench-size state every batch.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import FusionConfig


@dataclasses.dataclass
class GridState:
    """SoA voxel hash table + global pre-normal point buffer.

    ``C`` = capacity, ``W`` = bitmap words, ``B`` = buffer capacity,
    ``D`` = max dependants.
    """
    key: torch.Tensor           # (C,)   i32  dense cell id, -1 = empty slot
    occ_bits: torch.Tensor      # (W,)   i32  cell-id-keyed occupancy bits
    normal_found: torch.Tensor  # (C,)   bool
    normal: torch.Tensor        # (3C,)  f32  unit surface normal
    cyl_stats: torch.Tensor     # (5C,)  f32  [Σt, Σt², Σd, Σd², hits]
    viewpoint: torch.Tensor     # (3C,)  f32  first-occupancy viewpoint
    rgb_sum: torch.Tensor       # (3C,)  f32
    n_pts: torch.Tensor         # (C,)   f32  raw point count
    dep: torch.Tensor           # (D*C,) i32  owner slots, -1 = none
    dep_count: torch.Tensor     # (C,)   i32
    buf_pts: torch.Tensor       # (3,B)  f32
    buf_slot: torch.Tensor      # (B,)   i32  destination slot, -1 = empty
    buf_count: torch.Tensor     # ()     i32  live lanes are [0, buf_count)
    overflow_probe: torch.Tensor    # () i32  inserts dropped (probe bound)
    overflow_buf: torch.Tensor      # () i32  buffered points dropped
    overflow_dep: torch.Tensor      # () i32  dependant links dropped
    overflow_refine: torch.Tensor   # () i32  refine candidates deferred
    overflow_unique: torch.Tensor   # () i32  always 0 (no lane budget)
    overflow_hits: torch.Tensor     # () i32  always 0 (no lane budget)
    overflow_replay: torch.Tensor   # () i32  always 0 (no lane budget)
    overflow_active: torch.Tensor   # () i32  valid points dropped (NA)
    reclaimed: torch.Tensor         # () i32  buffer lanes freed
    frames: torch.Tensor            # () i32  frames integrated since clear

    @property
    def device(self) -> torch.device:
        return self.key.device


SCALAR_FIELDS = ("buf_count", "overflow_probe", "overflow_buf",
                 "overflow_dep", "overflow_refine", "overflow_unique",
                 "overflow_hits", "overflow_replay", "overflow_active",
                 "reclaimed", "frames")


def make_grid(config: FusionConfig, device) -> GridState:
    device = torch.device(device)
    C = config.capacity
    B = config.buffer_capacity
    D = config.max_dependants
    f32, i32 = torch.float32, torch.int32

    def full(n, fill, dtype):
        return torch.full((n,), fill, dtype=dtype, device=device)

    scalars = {f: torch.zeros((), dtype=i32, device=device)
               for f in SCALAR_FIELDS}
    return GridState(
        key=full(C, -1, i32),
        occ_bits=full(config.n_occ_words, 0, i32),
        normal_found=full(C, False, torch.bool),
        normal=full(3 * C, 0.0, f32),
        cyl_stats=full(5 * C, 0.0, f32),
        viewpoint=full(3 * C, 0.0, f32),
        rgb_sum=full(3 * C, 0.0, f32),
        n_pts=full(C, 0.0, f32),
        dep=full(D * C, -1, i32),
        dep_count=full(C, 0, i32),
        buf_pts=torch.zeros((3, B), dtype=f32, device=device),
        buf_slot=full(B, -1, i32),
        **scalars,
    )


def occupied_slots(grid: GridState) -> torch.Tensor:
    """(C,) bool: a voxel is occupied iff at least one point landed in it
    (ghost line cells have a key but no points)."""
    return grid.n_pts > 0


def occupied_at(grid: GridState, slots: torch.Tensor) -> torch.Tensor:
    """Occupancy at (clamped, in-range) slot indices."""
    return grid.n_pts[slots.long()] > 0


def count_at(grid: GridState, slots: torch.Tensor) -> torch.Tensor:
    """The cylinder hit count (int32, rounded half to even as the JAX
    package's ``jnp.round``) at (clamped, in-range) slot indices."""
    return torch.round(grid.cyl_stats.view(-1, 5)[slots.long(), 4]).to(
        torch.int32)


_QUICK_FIELDS = ("occupied_voxels", "normals_found", "refine_candidates",
                 "buffered_points", "frames",
                 "overflow_probe", "overflow_buffer", "overflow_dependants",
                 "overflow_refine", "overflow_unique", "overflow_hits",
                 "overflow_replay", "overflow_active",
                 "buffer_lanes_reclaimed", "max_dependants_used")


def _quick_values(grid: GridState) -> torch.Tensor:
    occ = occupied_slots(grid)
    nf = grid.normal_found
    return torch.stack([t.to(torch.int64) for t in (
        occ.sum(), nf.sum(), (occ & ~nf).sum(),
        grid.buf_count, grid.frames,
        grid.overflow_probe, grid.overflow_buf, grid.overflow_dep,
        grid.overflow_refine, grid.overflow_unique, grid.overflow_hits,
        grid.overflow_replay, grid.overflow_active,
        grid.reclaimed, grid.dep_count.max())])


def quick_counts(grid: GridState, config: FusionConfig) -> dict:
    """The 15 counters of the JAX package's ``quick_counts``, one fetch."""
    vals = _quick_values(grid).tolist()
    return dict(zip(_QUICK_FIELDS, vals))


def grid_metrics(grid: GridState, config: FusionConfig) -> dict:
    """Occupancy, load factor and overflow counters (the JAX package's 16
    keys), one device reduction and one fetch."""
    vals = torch.cat([_quick_values(grid),
                      (grid.key != -1).sum().to(torch.int64)[None]]).tolist()
    m = dict(zip(_QUICK_FIELDS, vals))
    used = vals[-1]
    return {
        "occupied_voxels": m["occupied_voxels"],
        "slots_used": used,
        "hash_load_factor": used / config.capacity,
        "normals_found": m["normals_found"],
        "max_dependants_used": m["max_dependants_used"],
        "buffered_points": m["buffered_points"],
        "frames": m["frames"],
        "overflow_probe": m["overflow_probe"],
        "overflow_buffer": m["overflow_buffer"],
        "overflow_dependants": m["overflow_dependants"],
        "overflow_refine": m["overflow_refine"],
        "overflow_unique": m["overflow_unique"],
        "overflow_hits": m["overflow_hits"],
        "overflow_replay": m["overflow_replay"],
        "overflow_active": m["overflow_active"],
        "buffer_lanes_reclaimed": m["buffer_lanes_reclaimed"],
    }
