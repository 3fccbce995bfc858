"""Voxel-grid geometry on planar (3, ...) tensors.

The counterpart of ``hifi_fusion_tpu/ops/geometry.py``, with the same
operation order, so that every f32 result is bit-identical to the JAX
package's:

* ``cell_coords``: ``floor((p - origin) * inv_res)`` with ``inv_res`` the
  f32 reciprocal ``1 / res`` rounded once.  The JAX source divides by
  ``res``, but ``res`` is a compile-time constant of every jitted program
  and XLA rewrites a division by a constant into a multiply by its folded
  reciprocal; about one coordinate in a million floors differently under
  the two forms, so the port multiplies as the JAX package's programs do;
* ``cell_center``: ``origin + res * (coord + 0.5)`` rounded once, as the
  fused multiply-add XLA makes of it;
* a shard of a slab-sharded grid (parallel/sharding.py) addresses cells
  in local coordinates, its cell coords shifted by a (3,) integer offset;
  world arithmetic and cell centers stay global (``shift``,
  ``center_of_ids``' ``offset``);
* ``transform_points``: ``((R00*x + R01*y) + R02*z) + t0``, one rounding
  per operation (no matmul, no fused multiply-add).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import FusionConfig


def _col(values, ndim: int, dtype, device) -> torch.Tensor:
    """(3,) constant -> (3, 1, 1, ...) tensor broadcastable over planar
    arrays of rank ``ndim``."""
    return torch.tensor(values, dtype=dtype, device=device).reshape(
        (3,) + (1,) * (ndim - 1))


def inv_resolution(config: FusionConfig) -> np.ndarray:
    """(3,) f32 ``1 / res``, divided in f32 as XLA folds the constant."""
    return np.float32(1.0) / np.asarray(config.resolution, np.float32)


def cell_coords(points: torch.Tensor, config: FusionConfig) -> torch.Tensor:
    """(3, ...) world points -> (3, ...) int32 cell coords (floor)."""
    f32 = torch.float32
    origin = _col(config.origin, points.dim(), f32, points.device)
    inv = _col(inv_resolution(config).tolist(), points.dim(), f32,
               points.device)
    return torch.floor((points - origin) * inv).to(torch.int32)


def cell_center(coords: torch.Tensor, config: FusionConfig) -> torch.Tensor:
    """(3, ...) int cell coords -> (3, ...) f32 cell centers
    ``fma(res, coord + 0.5, origin)``, rounded once.

    The JAX package writes ``origin + res * (coord + 0.5)``, and XLA on the
    CPU contracts it into a fused multiply-add; the kernels use
    ``__fmaf_rn``.  Here the operands are f32 values and the sum is
    computed in f64, where it is exact for grid coordinates (the product
    has at most 49 significant bits and the origin lies within the same
    few dozen binary orders), so one rounding to f32 gives the fused
    result bit for bit."""
    f32, f64 = torch.float32, torch.float64
    origin = _col(config.origin, coords.dim(), f32, coords.device)
    res = _col(config.resolution, coords.dim(), f32, coords.device)
    half = (coords.to(f32) + 0.5).to(f64)
    return (res.to(f64) * half + origin.to(f64)).to(f32)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a*b + c`` of f32 tensors (broadcast), rounded once to f32, as
    ``__fmaf_rn`` and XLA's contracted multiply-adds compute it.

    The product is exact in f64; the sum is rounded to f64 with round-to-
    odd (the TwoSum error decides the last bit), and a round-to-odd result
    with at least two more bits than f32 rounds to f32 exactly as the
    single rounding would, so no double-rounding case remains."""
    f64 = torch.float64
    p = a.to(f64) * b.to(f64)
    c64 = c.to(f64)
    t = p + c64
    back = t - p
    err = (p - (t - back)) + (c64 - back)
    bits = t.view(torch.int64)
    inexact_even = (err != 0) & ((bits & 1) == 0)
    away = (err > 0) == (t > 0)            # the exact sum lies beyond |t|
    bits = torch.where(inexact_even, bits + torch.where(away, 1, -1), bits)
    return bits.view(f64).to(torch.float32)


def valid_points(points: torch.Tensor, config: FusionConfig) -> torch.Tensor:
    """(3, ...) -> (...) bool: strictly inside the bbox (exclusive ends)."""
    b = config.bbox
    lo = _col([b[0], b[2], b[4]], points.dim(), torch.float32, points.device)
    hi = _col([b[1], b[3], b[5]], points.dim(), torch.float32, points.device)
    return ((points > lo) & (points < hi)).all(dim=0)


def valid_coords(coords: torch.Tensor, config: FusionConfig) -> torch.Tensor:
    """(3, ...) int coords -> (...) bool: inside [0, dim) per axis."""
    dims = _col(config.dims, coords.dim(), torch.int32, coords.device)
    return ((coords >= 0) & (coords < dims)).all(dim=0)


def cell_id(coords: torch.Tensor, config: FusionConfig) -> torch.Tensor:
    """(3, ...) int coords -> (...) int32 dense id ``(x*dy + y)*dz + z``."""
    _, dy, dz = config.dims
    c = coords.to(torch.int32)
    return (c[0] * dy + c[1]) * dz + c[2]


def id_to_coords(ids: torch.Tensor, config: FusionConfig) -> torch.Tensor:
    """(...) int32 dense id (>= 0) -> (3, ...) int32 coords."""
    _, dy, dz = config.dims
    z = ids % dz
    xy = ids // dz
    return torch.stack([xy // dy, xy % dy, z], dim=0)


def shift(coords: torch.Tensor, offset, sign: int = 1) -> torch.Tensor:
    """(3, ...) int coords plus ``sign`` times the (3,) int ``offset`` (a
    tuple; ``None`` is zero)."""
    if offset is None or not any(offset):
        return coords
    return coords + sign * _col(list(offset), coords.dim(), coords.dtype,
                                coords.device)


def center_of_ids(ids: torch.Tensor, config: FusionConfig,
                  offset=None) -> torch.Tensor:
    """Dense cell ids -> (3, ...) f32 GLOBAL cell centers.  ``offset``: a
    shard's local -> global coordinate offset (parallel/sharding.py), a
    (3,) int tuple; ``None`` for a single grid."""
    return cell_center(shift(id_to_coords(ids, config), offset), config)


def project_to_axis(q: torch.Tensor, n: torch.Tensor):
    """Centered axis projection, planar layout (JAX geometry.py:105):
    ``q = p - axis_center`` and the unit normal ``n``, both (3, ...) ->
    ``(q_proj (3, ...), dist (...))`` with ``q_proj = (q.n) n`` and
    ``dist = |q - q_proj|``, each sum taken in axis order."""
    t = (q[0] * n[0] + q[1] * n[1]) + q[2] * n[2]
    q_proj = t[None] * n
    r = q - q_proj
    return q_proj, torch.sqrt((r[0] * r[0] + r[1] * r[1]) + r[2] * r[2])


def transform_points(points: torch.Tensor, pose: torch.Tensor
                     ) -> torch.Tensor:
    """SE(3) transform of (3, N) points by a (4, 4) pose, or of (K, 3, N)
    points by (K, 4, 4) poses, as explicit multiply-adds."""
    if points.dim() == 3:
        R = pose[:, :3, :3, None]           # (K,3,3,1)
        t = pose[:, :3, 3, None]            # (K,3,1)
        x, y, z = points[:, 0], points[:, 1], points[:, 2]
        return torch.stack([
            R[:, 0, 0] * x + R[:, 0, 1] * y + R[:, 0, 2] * z + t[:, 0],
            R[:, 1, 0] * x + R[:, 1, 1] * y + R[:, 1, 2] * z + t[:, 1],
            R[:, 2, 0] * x + R[:, 2, 1] * y + R[:, 2, 2] * z + t[:, 2],
        ], dim=1)
    R = pose[:3, :3]
    t = pose[:3, 3]
    x, y, z = points[0], points[1], points[2]
    return torch.stack([
        R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0],
        R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1],
        R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2],
    ], dim=0)
