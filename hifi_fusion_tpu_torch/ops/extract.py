"""Extraction: the occupied voxels with a normal, as dense arrays.

The counterpart of ``extract_impl`` and ``to_host`` in
``hifi_fusion_tpu/ops/extract.py`` (:65-143).  Voxels that are occupied and
have a normal are emitted in ascending cell-id order (the reference's
x-major emission order) with finalized statistics:

* centroid = cell_center + normal * Σt/count (0 for count == 0),
* sd = normal² * (Σt²/count - (Σt/count)²), per axis,
* mean_dist, sd_dist from Σd, Σd²; count; mean rgb; raw point count.

The result is sized from the live number of voxels: no static cap and no
re-extract path.  A shard of a slab-sharded grid emits only its core slab
(``x_range``, local x) with global centers (``offset``); its ``cell`` ids
stay local (parallel/sharding.py maps them to global int64 ids).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import FusionConfig
from ..grid import GridState, occupied_slots
from . import geometry


@dataclasses.dataclass
class ExtractResult:
    n_valid: int
    cell: torch.Tensor       # (n,)  i32 dense cell id, ascending
    centroid: torch.Tensor   # (3,n) f32
    normal: torch.Tensor     # (3,n) f32
    sd: torch.Tensor         # (3,n) f32
    mean_dist: torch.Tensor  # (n,)  f32
    sd_dist: torch.Tensor    # (n,)  f32
    count: torch.Tensor      # (n,)  i32 points inside the 1 mm cylinder
    rgb: torch.Tensor        # (3,n) f32 mean colour
    n_pts: torch.Tensor      # (n,)  i32 raw points in the voxel


EXTRACT_FIELDS = ("cell", "centroid", "normal", "sd", "mean_dist", "sd_dist",
                  "count", "rgb", "n_pts")
_PLANAR_FIELDS = ("centroid", "normal", "sd", "rgb")


def extract(grid: GridState, config: FusionConfig, x_range=None,
            offset=None) -> ExtractResult:
    """The emitted voxels; ``x_range=(lo, hi)`` keeps those whose local x
    cell lies in [lo, hi), ``offset`` makes the centers global (JAX
    extract.py:66-101)."""
    keep = occupied_slots(grid) & grid.normal_found
    if x_range is not None:
        _, dy, dz = config.dims
        cx = grid.key // (dy * dz)
        keep = keep & (cx >= x_range[0]) & (cx < x_range[1])
    slots = torch.nonzero(keep).squeeze(1)
    cell, perm = torch.sort(grid.key[slots])
    order = slots[perm]
    center = geometry.center_of_ids(cell, config, offset)
    normal = grid.normal.view(-1, 3)[order].t()
    stats = grid.cyl_stats.view(-1, 5)[order].t()
    cnt = torch.round(stats[4]).to(torch.int32)
    cnt_f = torch.clamp(stats[4], min=1.0)
    mean_t = stats[0] / cnt_f
    has = cnt > 0
    zero = torch.zeros((), dtype=torch.float32, device=grid.device)
    centroid = torch.where(has[None], center + normal * mean_t[None], zero)
    var_t = stats[1] / cnt_f - mean_t * mean_t
    sd = torch.where(has[None], (normal * normal) * var_t[None], zero)
    mean_d = torch.where(has, stats[2] / cnt_f, zero)
    sd_d = torch.where(has, stats[3] / cnt_f - mean_d * mean_d, zero)
    npts = grid.n_pts[order]
    rgb = grid.rgb_sum.view(-1, 3)[order].t() / torch.clamp(npts, min=1.0)
    return ExtractResult(
        n_valid=int(cell.numel()), cell=cell, centroid=centroid,
        normal=normal, sd=sd, mean_dist=mean_d, sd_dist=sd_d, count=cnt,
        rgb=rgb, n_pts=npts.to(torch.int32))


def to_host(result: ExtractResult, fields=None, prefetch=()) -> dict:
    """ExtractResult -> dict of numpy arrays; planar fields become
    row-major (n,3).  ``fields``: the fields fetched, in that order (None:
    every field of ``EXTRACT_FIELDS``).  ``prefetch`` is the JAX package's
    argument (extract.py:196) and does nothing here: each call copies the
    fields it was asked for, synchronously."""
    want = EXTRACT_FIELDS if fields is None else tuple(fields)
    unknown = [f for f in want if f not in EXTRACT_FIELDS]
    if unknown:
        raise ValueError(f"unknown extract fields {unknown}")
    out = {}
    for f in want:
        a = getattr(result, f).detach().cpu().numpy()
        out[f] = np.ascontiguousarray(a.T) if f in _PLANAR_FIELDS else a
    return out


def cached_fetch(fetch_fields, all_fields):
    """``fetch(fields=None, prefetch=())`` over one extraction, as the JAX
    package's ``extract_fetcher``s return it: ``fetch_fields(names)`` is
    called only for the fields not fetched before, and every field is
    kept, so a caller can take one set of fields now and another later
    for one host copy each; ``fields=None`` means ``all_fields``."""
    cache = {}

    def fetch(fields=None, prefetch=()):
        want = tuple(all_fields if fields is None else fields)
        need = [f for f in want if f not in cache]
        if need:
            cache.update(fetch_fields(need))
        return {f: cache[f] for f in want}

    return fetch
