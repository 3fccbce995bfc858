"""The eye-in-hand depth sweep, frozen for the benchmark.

Copied from ``hifi_fusion_tpu_torch/utils/synthetic.py`` (``_look_down_pose``
:28-36, ``DEPTH_SCALE`` :180, ``camera_rays`` :183-195 and
``make_depth_sweep`` :198-252), so a change to the program cannot change
the traffic.  Two changes: the sweep takes the bbox instead of a
``FusionConfig``, and its random draws (the depth noise, then the rgb565
words) come from one ``torch.Generator`` on ``device`` in two calls for
the whole sweep, where the fixed-point solve also runs, every frame at
once, in float64.  The geometry is the original's: the wavy surface
``z = z0 + a sin(7x) cos(5y)``, a camera looking down from
``camera_height`` above it, its x position stepping along a fixed arc by
``arc / arc_frames`` a frame, four fixed-point steps for each pixel's
depth, quantized to u16 units of ``DEPTH_SCALE``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# depth units: 2^-16 m; a power of two keeps ``q * (ray*scale)`` a single
# exactly-reproducible f32 multiply.
DEPTH_SCALE = 2.0 ** -16


def look_down_pose(cx: float, cy: float, cz: float) -> np.ndarray:
    """Camera at (cx,cy,cz) looking along -z of the fusion frame."""
    pose = np.eye(4, dtype=np.float64)
    pose[:3, :3] = np.asarray([[1.0, 0.0, 0.0],
                               [0.0, -1.0, 0.0],
                               [0.0, 0.0, -1.0]])
    pose[:3, 3] = [cx, cy, cz]
    return pose


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


@dataclasses.dataclass
class DepthSweep:
    """A sweep's frames as host arrays: ``depth_q`` (F,N) u16 z-depth in
    units of ``DEPTH_SCALE``, ``rgb565`` (F,N) u16, ``poses`` (F,4,4) f32
    camera-to-fusion poses, ``srays`` (3,N) f32 scaled rays."""
    depth_q: np.ndarray
    rgb565: np.ndarray
    poses: np.ndarray
    srays: np.ndarray

    @property
    def n_frames(self) -> int:
        return self.depth_q.shape[0]

    @property
    def n_pixels(self) -> int:
        return self.depth_q.shape[1]


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number (taken
    modulo 2^64, so large and negative seeds are valid)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def make_depth_sweep(bbox, n_frames: int, width: int = 640,
                     height: int = 480, fx: float = 900.0, seed: int = 0,
                     noise_sd: float = 3e-4, surface_frac: float = 0.5,
                     camera_height: float = 0.4, arc_frames: int = None,
                     device="cpu") -> DepthSweep:
    """The wavy surface observed as organized z-depth images from a camera
    sweeping along x; ``arc_frames`` sets the pose spacing (the arc over
    ``arc_frames - 1``, default ``n_frames - 1``)."""
    dev = torch.device(device)
    f64 = torch.float64
    srays = camera_rays(width, height, fx=fx, fy=fx)
    rays64 = torch.from_numpy(srays.astype(np.float64) / DEPTH_SCALE).to(dev)
    b = bbox
    xr = (b[1] - b[0]) * surface_frac
    x0 = (b[0] + b[1]) / 2 - xr / 2
    y0 = (b[2] + b[3]) / 2
    z0 = b[4] + 0.35 * (b[5] - b[4])
    amp = 0.06 * (b[5] - b[4])
    n = width * height
    denom = max((arc_frames or n_frames) - 1, 1)
    cxs = [x0 + xr * (0.25 + 0.5 * f / denom) for f in range(n_frames)]
    cz = z0 + camera_height
    poses = np.stack([look_down_pose(cx, y0, cz) for cx in cxs])

    g = generator(seed, dev)
    noise = torch.randn((n_frames, n), generator=g, device=dev,
                        dtype=f64) * noise_sd
    rgb = torch.randint(0, 1 << 16, (n_frames, n), generator=g, device=dev,
                        dtype=torch.int32)
    cx = torch.tensor(cxs, dtype=f64, device=dev)[:, None]
    z = torch.full((n_frames, n), camera_height, dtype=f64, device=dev)
    for _ in range(4):
        wx = cx + rays64[0] * z
        wy = y0 - rays64[1] * z
        z = cz - z0 - amp * torch.sin(7.0 * wx) * torch.cos(5.0 * wy) - noise
    depth_q = torch.clamp(torch.round(z / DEPTH_SCALE), 0, 65535).to(
        torch.int32)
    return DepthSweep(
        depth_q=depth_q.cpu().numpy().astype(np.uint16),
        rgb565=rgb.cpu().numpy().astype(np.uint16),
        poses=poses.astype(np.float32),
        srays=srays)
