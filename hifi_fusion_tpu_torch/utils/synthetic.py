"""Synthetic sensor-native depth sweeps (numpy only).

A copy of the depth half of ``hifi_fusion_tpu/utils/synthetic.py``: the
wavy surface patch observed as organized u16 z-depth images with rgb565
colour, as a RealSense-class camera emits them.  The port cannot import the
JAX package's module (that import pulls in ``jax``), so the code is
copied; ``tests/test_torch_config_synthetic.py`` checks that both give
byte-identical sweeps for one seed.  All randomness comes from
``np.random.default_rng(seed)``.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..config import FusionConfig


def _look_down_pose(cx: float, cy: float, cz: float) -> np.ndarray:
    """Camera at (cx,cy,cz) looking along -z of the fusion frame."""
    pose = np.eye(4, dtype=np.float64)
    pose[:3, :3] = np.asarray([[1.0, 0.0, 0.0],
                               [0.0, -1.0, 0.0],
                               [0.0, 0.0, -1.0]])
    pose[:3, 3] = [cx, cy, cz]
    return pose


@dataclasses.dataclass
class DepthFrame:
    """Sensor-native wire format: 4 B/pixel (u16 z-depth + rgb565).

    The device unprojects ``pc = depth_q.astype(f32) * srays`` against a
    resident (3,N) f32 ray table; ``points_f32`` is the identical host-side
    computation.
    """
    depth_q: np.ndarray    # (N,) u16 z-depth in units of DEPTH_SCALE
    rgb565: np.ndarray     # (N,) u16 packed 5:6:5 color
    pose: np.ndarray       # (4,4) f32 fusion_T_camera
    count: int             # valid prefix length (== N for organized frames)
    points_f32: np.ndarray  # (3,N) f32 canonical camera-frame points


# depth units: 2^-16 m; a power of two keeps ``q * (ray*scale)`` a single
# exactly-reproducible f32 multiply.
DEPTH_SCALE = 2.0 ** -16


def camera_rays(width: int = 640, height: int = 480,
                fx: float = 500.0, fy: float = 500.0,
                scale: float = DEPTH_SCALE) -> np.ndarray:
    """(3, width*height) f32 scaled pinhole rays: ``srays[:, i] =
    ((u-cx)/fx, (v-cy)/fy, 1) * scale`` in row-major pixel order."""
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    u = np.arange(width, dtype=np.float64)
    v = np.arange(height, dtype=np.float64)
    rx = np.broadcast_to((u - cx) / fx, (height, width))
    ry = np.broadcast_to(((v - cy) / fy)[:, None], (height, width))
    rays = np.stack([rx.ravel(), ry.ravel(),
                     np.ones(width * height)], axis=0)
    return (rays * scale).astype(np.float32)


def make_depth_sweep(config: FusionConfig,
                     n_frames: int,
                     width: int = 640,
                     height: int = 480,
                     seed: int = 0,
                     noise_sd: float = 3e-4,
                     surface_frac: float = 0.5,
                     camera_height: float = 0.4,
                     srays: np.ndarray = None,
                     arc_frames: int = None) -> List[DepthFrame]:
    """The wavy surface observed as organized z-depth images.

    Each pixel's depth solves ``camera_z - z = surface(world(z))`` by
    fixed-point iteration in f64, then quantizes to u16.  ``arc_frames``
    sets the pose spacing (the fixed arc divided by ``arc_frames``, default
    ``n_frames``), so a shorter sweep covers a prefix of a longer one at the
    same per-frame spacing.
    """
    rng = np.random.default_rng(seed)
    if srays is None:
        srays = camera_rays(width, height)
    rays64 = srays.astype(np.float64) / DEPTH_SCALE      # unit-z rays
    b = config.bbox
    xr = (b[1] - b[0]) * surface_frac
    x0 = (b[0] + b[1]) / 2 - xr / 2
    y0 = (b[2] + b[3]) / 2
    z0 = b[4] + 0.35 * (b[5] - b[4])
    amp = 0.06 * (b[5] - b[4])
    n = width * height
    denom = max((arc_frames or n_frames) - 1, 1)

    frames = []
    for f in range(n_frames):
        cx = x0 + xr * (0.25 + 0.5 * f / denom)
        cy = y0
        cz = z0 + camera_height
        pose = _look_down_pose(cx, cy, cz)
        noise = rng.normal(0.0, noise_sd, n)
        z = np.full(n, camera_height)
        for _ in range(4):
            wx = cx + rays64[0] * z
            wy = cy - rays64[1] * z
            z = (cz - z0 - amp * np.sin(7.0 * wx) * np.cos(5.0 * wy)
                 - noise)
        depth_q = np.clip(np.rint(z / DEPTH_SCALE), 0, 65535).astype(
            np.uint16)
        pf = depth_q.astype(np.float32)[None, :] * srays    # (3,N)
        frames.append(DepthFrame(
            depth_q=depth_q,
            rgb565=rng.integers(0, 1 << 16, n).astype(np.uint16),
            pose=pose.astype(np.float32),
            count=n,
            points_f32=pf,
        ))
    return frames
