"""PointCloud2 records of a depth sweep, frozen for the benchmark.

Copied from ``chip_smoke.py`` (``rgb8`` :1270-1275, ``camera_points``
:1278-1281, ``cloud_frames`` :1284-1291) and the record layout of
``hifi_fusion_tpu_torch/runtime/decode.py`` ``make_cloud_frame`` (:59-77):
each valid pixel (depth > 0) becomes one 16-byte point, x, y, z as f32
and the colour packed ``0x00RRGGBB`` into the fourth word, the
RealSense-style layout the reference node subscribes to.  One change: the
records of every frame are encoded in one vectorised pass and returned as
bytes, so the caller wraps them in the program's message type.
"""

from __future__ import annotations

import numpy as np

POINT_STEP = 16
FIELDS = (("x", 0), ("y", 4), ("z", 8), ("rgb", 12))


def rgb8(rgb565) -> np.ndarray:
    """(..., n) u16 rgb565 -> (..., n, 3) f32 8-bit channels, as the
    frontends expand them (x8, x4, x8)."""
    v = rgb565.astype(np.uint32)
    return np.stack([((v >> 11) & 0x1F) * 8, ((v >> 5) & 0x3F) * 4,
                     (v & 0x1F) * 8], axis=-1).astype(np.float32)


def camera_points(depth_q, srays) -> np.ndarray:
    """(n,3) f32 camera points of one frame's valid pixels (depth > 0):
    ``depth * ray``, one f32 multiply, as the card unprojects them."""
    ok = depth_q > 0
    pf = depth_q[ok].astype(np.float32)[None, :] * srays[:, ok]
    return np.ascontiguousarray(pf.T)


def cloud_records(depth_q, rgb565, srays) -> list:
    """(F,N) depth and rgb565 -> one ``bytes`` record block a frame: the
    frame's valid pixels as 16-byte points."""
    out = []
    for f in range(depth_q.shape[0]):
        ok = depth_q[f] > 0
        rec = np.zeros((int(ok.sum()), 4), np.float32)
        rec[:, 0:3] = camera_points(depth_q[f], srays)
        c = rgb8(rgb565[f][ok])
        r = np.clip(c[:, 0], 0, 255).astype(np.uint32)
        g = np.clip(c[:, 1], 0, 255).astype(np.uint32)
        b = np.clip(c[:, 2], 0, 255).astype(np.uint32)
        rec[:, 3] = ((r << 16) | (g << 8) | b).view(np.float32)
        out.append(rec.tobytes())
    return out
