"""Synthetic eye-in-hand sweeps (numpy only).

A copy of ``hifi_fusion_tpu/utils/synthetic.py``'s two halves:

* the planar half (``Frame``, ``make_sweep``, ``PackedFrame``,
  ``pack_frame_q16``, ``pad_frame``): a wavy surface patch sampled in the
  fusion frame and observed, one shifted window a frame, from a camera
  pose inside the reference clip window, as (N,3) camera-frame points;
* the depth half: the same surface observed as organized u16 z-depth
  images with rgb565 colour, as a RealSense-class camera emits them.

The port cannot import the JAX package's module (that import pulls in
``jax``), so the code is copied; ``tests/test_torch_config_synthetic.py``
checks that both give byte-identical frames for one seed.  All randomness
comes from ``np.random.default_rng(seed)``.
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


# -- the planar half ---------------------------------------------------------

@dataclasses.dataclass
class Frame:
    points_cam: np.ndarray  # (N,3) f32
    rgb: np.ndarray         # (N,3) f32
    pose: np.ndarray        # (4,4) f32 fusion_T_camera
    mask: np.ndarray        # (N,)  bool


def make_sweep(config: FusionConfig,
               n_frames: int,
               points_per_frame: int,
               seed: int = 0,
               noise_sd: float = 3e-4,
               surface_frac: float = 0.5,
               camera_height: float = 0.4) -> List[Frame]:
    """A sweep over a wavy surface z = z0 + a*sin*cos patch.  Camera-frame
    points come from the inverse pose applied in f64, so f32 forward
    transforms land within ~1e-7 m of the intended world samples."""
    rng = np.random.default_rng(seed)
    b = config.bbox
    xr = (b[1] - b[0]) * surface_frac
    yr = (b[3] - b[2]) * surface_frac
    x0 = (b[0] + b[1]) / 2 - xr / 2
    y0 = (b[2] + b[3]) / 2 - yr / 2
    z0 = b[4] + 0.35 * (b[5] - b[4])
    amp = 0.06 * (b[5] - b[4])

    frames = []
    for f in range(n_frames):
        # a sliding window over the surface (eye-in-hand sweep)
        u = rng.random(points_per_frame)
        v = rng.random(points_per_frame)
        wx = x0 + xr * (0.25 + 0.5 * f / max(n_frames - 1, 1)
                        ) + 0.25 * xr * (u - 0.5) * 2
        wy = y0 + yr * (0.5 + 0.45 * (v - 0.5) * 2)
        wz = (z0 + amp * np.sin(7.0 * wx) * np.cos(5.0 * wy)
              + rng.normal(0.0, noise_sd, points_per_frame))
        world = np.stack([wx, wy, wz], axis=-1)

        cx = np.mean(wx)
        cy = np.mean(wy)
        pose = _look_down_pose(cx, cy, z0 + camera_height)
        inv = np.linalg.inv(pose)
        pts_cam = (world @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)

        rgb = rng.integers(0, 256, (points_per_frame, 3)).astype(np.float32)
        frames.append(Frame(
            points_cam=pts_cam,
            rgb=rgb,
            pose=pose.astype(np.float32),
            mask=np.ones(points_per_frame, bool),
        ))
    return frames


@dataclasses.dataclass
class PackedFrame:
    """The q16 wire format: 10 B a point instead of ``pad_frame``'s 25 B
    (u16 quantized points, a per-axis [scale, offset], packed u32 rgb and
    a count prefix); the device frontend dequantizes and unpacks."""
    points_q: np.ndarray   # (3,N) u16 quantized camera-frame points
    quant: np.ndarray      # (2,3) f32: [scale, offset] per axis
    rgb_u32: np.ndarray    # (N,)  u32 packed 0xRRGGBB
    count: int             # number of valid points (prefix)
    pose: np.ndarray       # (4,4) f32
    points_f32: np.ndarray  # (3,N) f32 dequantized points: exactly what
    #                         the device reconstructs


def pack_frame_q16(frame: Frame, n_max: int) -> PackedFrame:
    """Quantize a frame to the u16 wire format, bit-reproducibly.

    The per-axis scale is a power of two >= range/65535, so ``q * scale``
    is exact (q < 2^16) and ``q * scale + offset`` rounds once, the same
    with or without a fused multiply-add; ``points_f32`` is that
    dequantization, the values every consumer must agree on."""
    n = frame.points_cam.shape[0]
    if n > n_max:
        raise ValueError(f"frame has {n} points > max_points {n_max}")
    pts = frame.points_cam.astype(np.float32)      # (N,3)
    lo = pts.min(axis=0)
    rng = pts.max(axis=0) - lo
    # scale = 2^ceil(log2(range/65535)); degenerate axes get scale 2^-24
    exp = np.where(rng > 0, np.ceil(np.log2(np.maximum(rng, 1e-30)
                                            / 65535.0)), -24.0)
    scale = np.exp2(exp).astype(np.float32)
    offset = lo.astype(np.float32)
    q = np.clip(np.rint((pts - offset) / scale), 0, 65535).astype(np.uint16)
    pq = np.zeros((3, n_max), np.uint16)
    pq[:, :n] = q.T
    # dequantize the padded array so points_f32 matches the device lane
    # for lane (padding lanes dequantize to the offset; masked anyway)
    pf = pq.astype(np.float32) * scale[:, None] + offset[:, None]
    r = frame.rgb.astype(np.uint32)
    rgb_u32 = np.zeros((n_max,), np.uint32)
    rgb_u32[:n] = (r[:, 0] << 16) | (r[:, 1] << 8) | r[:, 2]
    return PackedFrame(
        points_q=pq,
        quant=np.stack([scale, offset]).astype(np.float32),
        rgb_u32=rgb_u32,
        count=n,
        pose=frame.pose.astype(np.float32),
        points_f32=pf,
    )


def pad_frame(frame: Frame, n_max: int) -> Frame:
    """Pad a frame to the static lane budget with masked lanes, in the
    device's planar layout: points_cam and rgb become (3, n_max)."""
    n = frame.points_cam.shape[0]
    if n > n_max:
        raise ValueError(f"frame has {n} points > max_points {n_max}")
    pts = np.zeros((3, n_max), np.float32)
    rgb = np.zeros((3, n_max), np.float32)
    mask = np.zeros(n_max, bool)
    pts[:, :n] = frame.points_cam.T
    rgb[:, :n] = frame.rgb.T
    mask[:n] = frame.mask
    return Frame(points_cam=pts, rgb=rgb, pose=frame.pose, mask=mask)


# -- the depth half ----------------------------------------------------------

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
