"""Sensor frame decoding: PointCloud2-style binary records -> arrays.

A copy of ``hifi_fusion_tpu/runtime/decode.py`` (the port cannot import
the JAX package).  A RealSense-style stream delivers interleaved per-point
records (x, y, z f32 and a packed rgb float) with a stride; organized
clouds (height > 1) decode every row.  ``record_fields`` reads and checks
a frame's record layout: all a fusion session does on the host before
kernel K5 decodes the records on the card (``ops/integrate
.record_frontend``).  ``decode_frame`` runs the native host runtime's
C++/OpenMP decode (``runtime/native``, built with ``g++`` at first use; a
failed build raises), as the JAX package's does when its library is
built.  ``_decode_numpy``, a strided NumPy copy, is the format oracle the
tests hold the library and the record wire to; the session never takes
it.

The reference's blue-channel bug (packed blue extracted with a shift of 1
instead of 0, FUSION.cpp:174) is fixed by default and reproduced behind
``blue_shift_bug=True``.  ``tests/test_torch_planar.py`` holds this module
to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from . import native

# sensor_msgs/PointField datatype codes
FLOAT32 = 7


@dataclasses.dataclass
class PointField:
    name: str
    offset: int
    datatype: int = FLOAT32
    count: int = 1


@dataclasses.dataclass
class CloudFrame:
    """A PointCloud2-equivalent message (transport-agnostic)."""
    data: bytes
    point_step: int
    width: int
    height: int = 1
    fields: List[PointField] = dataclasses.field(default_factory=list)
    frame_id: str = "camera"
    stamp: float = 0.0

    @property
    def n_points(self) -> int:
        return self.width * self.height

    def field_offset(self, name: str) -> Optional[int]:
        for f in self.fields:
            if f.name == name:
                return f.offset
        return None


def make_cloud_frame(xyz: np.ndarray, rgb: Optional[np.ndarray] = None,
                     frame_id: str = "camera", stamp: float = 0.0
                     ) -> CloudFrame:
    """Encode (N,3) arrays into an interleaved RealSense-style record
    (x, y, z, packed rgb; a 16-byte point_step)."""
    n = xyz.shape[0]
    rec = np.zeros((n, 4), np.float32)
    rec[:, 0:3] = xyz.astype(np.float32)
    fields = [PointField("x", 0), PointField("y", 4), PointField("z", 8)]
    if rgb is not None:
        r = np.clip(rgb[:, 0], 0, 255).astype(np.uint32)
        g = np.clip(rgb[:, 1], 0, 255).astype(np.uint32)
        b = np.clip(rgb[:, 2], 0, 255).astype(np.uint32)
        rec[:, 3] = ((r << 16) | (g << 8) | b).view(np.float32)
        fields.append(PointField("rgb", 12))
    return CloudFrame(data=rec.tobytes(), point_step=16, width=n,
                      fields=fields, frame_id=frame_id, stamp=stamp)


def record_fields(frame: CloudFrame) -> Tuple[int, int, int, int, int, int]:
    """The frame's record layout, ``(n_points, point_step, off_x, off_y,
    off_z, off_rgb)`` with ``off_rgb`` -1 when the records carry no colour,
    checked as the decode checks it: raises ValueError when x, y or z is
    missing, the buffer holds fewer than n_points records, or a field's
    four bytes lie outside the record."""
    off_x = frame.field_offset("x")
    off_y = frame.field_offset("y")
    off_z = frame.field_offset("z")
    off_rgb = frame.field_offset("rgb")
    if off_x is None or off_y is None or off_z is None:
        raise ValueError("cloud frame lacks x/y/z fields")
    off_rgb = -1 if off_rgb is None else off_rgb
    n, step = frame.n_points, frame.point_step
    if len(frame.data) < n * step or n < 0:
        raise ValueError(f"{len(frame.data)} bytes hold fewer than {n} "
                         f"records of {step} bytes")
    if max(off_x, off_y, off_z, off_rgb) + 4 > step \
            or min(off_x, off_y, off_z) < 0:
        raise ValueError("a field lies outside the point record")
    return n, step, off_x, off_y, off_z, off_rgb


def decode_frame(frame: CloudFrame, blue_shift_bug: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """CloudFrame -> ((N,3) f32 xyz, (N,3) f32 rgb in [0,255])."""
    return native.decode_xyzrgb(frame.data, *record_fields(frame),
                                blue_shift_bug)


def _decode_numpy(frame: CloudFrame, off_x: int, off_y: int, off_z: int,
                  off_rgb: Optional[int], blue_shift_bug: bool
                  ) -> Tuple[np.ndarray, np.ndarray]:
    n = frame.n_points
    step = frame.point_step
    offs = [off_x, off_y, off_z] + ([] if off_rgb is None else [off_rgb])
    if step % 4 == 0 and all(o % 4 == 0 for o in offs):
        # 4-byte aligned fields: strided word views, one copy a field
        # (~4x faster than the byte copies below; the same bits).  xyz
        # comes out column-major, so its transpose is the planar layout
        words = np.frombuffer(frame.data, np.float32,
                              count=n * step // 4).reshape(n, step // 4)
        xyz = words[:, [off_x // 4, off_y // 4, off_z // 4]]
        packed = None if off_rgb is None \
            else words[:, off_rgb // 4].view(np.uint32)
    else:
        raw = np.frombuffer(frame.data, np.uint8,
                            count=n * step).reshape(n, step)

        def f32_at(off: int) -> np.ndarray:
            return raw[:, off:off + 4].copy().view(np.float32)[:, 0]

        xyz = np.stack([f32_at(off_x), f32_at(off_y), f32_at(off_z)],
                       axis=-1).astype(np.float32)
        packed = None if off_rgb is None else \
            raw[:, off_rgb:off_rgb + 4].copy().view(np.uint32)[:, 0]
    rgb = np.zeros((3, n), np.float32).T     # column-major, as xyz
    if packed is not None:
        blue_shift = 1 if blue_shift_bug else 0
        rgb[:, 0] = (packed >> 16) & 0xFF
        rgb[:, 1] = (packed >> 8) & 0xFF
        rgb[:, 2] = (packed >> blue_shift) & 0xFF
    return xyz, rgb
