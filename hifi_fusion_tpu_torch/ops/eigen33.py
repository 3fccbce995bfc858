"""Batched closed-form symmetric 3x3 eigensolver (smallest eigenpair).

The counterpart of ``hifi_fusion_tpu/ops/eigen33.py``: trigonometric
(Cardano) eigenvalues plus the largest-row-cross-product eigenvector, the
trick ``pcl::eigen33`` uses.  It is the plain version of the normal fit in
kernel K4 (``csrc/normal_fit.cu`` carries the same arithmetic as a device
function).

Every division is by a tensor on the operands' device: PyTorch's CUDA
division by a Python scalar multiplies by its reciprocal, one rounding
away from the true division the JAX package and the kernel perform.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

_EPS = 1e-20


def smallest_eigenpair_sym(a00, a01, a02, a11, a12, a22
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Six unique entries of symmetric matrices (any common shape S) ->
    ``(eigenvalue S, eigenvector (3,) + S planar)``; the eigenvector's sign
    is arbitrary (callers orient it)."""
    scale = torch.maximum(
        torch.maximum(torch.maximum(a00.abs(), a11.abs()),
                      torch.maximum(a22.abs(), a01.abs())),
        torch.maximum(a02.abs(), a12.abs()))
    scale = torch.where(scale < _EPS, torch.ones_like(scale), scale)
    three, six = (torch.tensor(v, dtype=a00.dtype, device=a00.device)
                  for v in (3.0, 6.0))
    a00, a01, a02 = a00 / scale, a01 / scale, a02 / scale
    a11, a12, a22 = a11 / scale, a12 / scale, a22 / scale

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / three
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / six, min=0.0))
    safe_p = torch.where(p < _EPS, torch.ones_like(p), p)

    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02)) / (safe_p * safe_p * safe_p)
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / three
    eig_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    eig_min = torch.where(p < _EPS, q, eig_min)

    vec = _eigenvector_sym(a00, a01, a02, a11, a12, a22, eig_min)
    return eig_min * scale, vec


def smallest_eigenpair(cov: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The matrix interface (JAX eigen33.py:108): (..., 3, 3) symmetric
    matrices -> ``(eigenvalue (...), eigenvector (..., 3))``, over
    ``smallest_eigenpair_sym``."""
    val, vec = smallest_eigenpair_sym(
        cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2])
    return val, torch.movedim(vec, 0, -1)


def _eigenvector_sym(a00, a01, a02, a11, a12, a22, lam) -> torch.Tensor:
    """Null-space direction of (A - lam I) via the largest row cross
    product; a coordinate axis when the matrix is fully degenerate."""
    m00, m11, m22 = a00 - lam, a11 - lam, a22 - lam

    def cross(ax, ay, az, bx, by, bz):
        return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)

    c01 = cross(m00, a01, a02, a01, m11, a12)
    c02 = cross(m00, a01, a02, a02, a12, m22)
    c12 = cross(a01, m11, a12, a02, a12, m22)

    def sq(c):
        return c[0] * c[0] + c[1] * c[1] + c[2] * c[2]

    n01, n02, n12 = sq(c01), sq(c02), sq(c12)
    best12 = n12 > torch.maximum(n01, n02)
    best02 = (n02 >= n12) & (n02 > n01)

    def pick(i):
        return torch.where(best12, c12[i], torch.where(best02, c02[i],
                                                       c01[i]))

    vx, vy, vz = pick(0), pick(1), pick(2)
    nrm = torch.sqrt(torch.clamp(vx * vx + vy * vy + vz * vz, min=0.0))
    ok = nrm > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(nrm < 1e-30,
                                            torch.ones_like(nrm), nrm),
                      torch.zeros_like(nrm))
    d0, d1, d2 = m00.abs(), m11.abs(), m22.abs()
    f0 = (d0 <= d1) & (d0 <= d2)
    f1 = ~f0 & (d1 <= d2)
    f2 = ~f0 & ~f1
    vx = torch.where(ok, vx * inv, f0.to(vx.dtype))
    vy = torch.where(ok, vy * inv, f1.to(vy.dtype))
    vz = torch.where(ok, vz * inv, f2.to(vz.dtype))
    return torch.stack([vx, vy, vz], dim=0)
