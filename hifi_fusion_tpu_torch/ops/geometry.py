"""Voxel-grid geometry on planar (3, ...) tensors.

The counterpart of ``hifi_fusion_tpu/ops/geometry.py``, with the same
operation order, so that every f32 result is bit-identical to the JAX
package's:

* ``cell_coords``: ``floor((p - origin) / res)`` with a true division (a
  reciprocal multiply, as PyTorch's CUDA division does for a CPU-scalar
  divisor, would move borderline points into another cell; the divisor is
  therefore always a device tensor);
* ``cell_center``: ``origin + res * (coord + 0.5)`` rounded once, as the
  fused multiply-add XLA makes of it;
* ``transform_points``: ``((R00*x + R01*y) + R02*z) + t0``, one rounding
  per operation (no matmul, no fused multiply-add).
"""

from __future__ import annotations

import torch

from ..config import FusionConfig


def _col(values, ndim: int, dtype, device) -> torch.Tensor:
    """(3,) constant -> (3, 1, 1, ...) tensor broadcastable over planar
    arrays of rank ``ndim``."""
    return torch.tensor(values, dtype=dtype, device=device).reshape(
        (3,) + (1,) * (ndim - 1))


def cell_coords(points: torch.Tensor, config: FusionConfig) -> torch.Tensor:
    """(3, ...) world points -> (3, ...) int32 cell coords (floor)."""
    f32 = torch.float32
    origin = _col(config.origin, points.dim(), f32, points.device)
    res = _col(config.resolution, points.dim(), f32, points.device)
    return torch.floor((points - origin) / res).to(torch.int32)


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


def center_of_ids(ids: torch.Tensor, config: FusionConfig) -> torch.Tensor:
    """Dense cell ids -> (3, ...) f32 cell centers."""
    return cell_center(id_to_coords(ids, config), config)


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
