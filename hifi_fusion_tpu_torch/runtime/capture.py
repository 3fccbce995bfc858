"""Recorded-capture ingestion: a directory of PCD/PLY frames + a pose
trajectory file.

A copy of ``hifi_fusion_tpu/runtime/capture.py`` (numpy only) over the
port's own ``io`` readers and ``runtime/decode`` / ``runtime/sources``;
``tests/test_torch_capture.py`` holds it equal.  It is the ROS-free
equivalent of replaying a recorded bag into the reference's subscriber+TF
ingest (onReceivedPointCloud, pointcloud_fusion_and_filter.cpp:327-349).

Layout of a capture directory::

    capture/
      frame_0000.pcd     # or .ply; camera-frame points (+ optional rgb)
      frame_0001.pcd
      ...
      poses.tum          # or poses.txt / trajectory.tum / poses.csv

Pose formats, matched to the lexicographically sorted frame files by row
order (row i -> frame i; row count must equal frame count):

* TUM trajectory (``.tum``/``.txt``): ``timestamp tx ty tz qx qy qz qw``
  per line, ``#`` comments — the de-facto interchange format for RGBD
  trajectories.
* CSV (``.csv``): header + rows of either ``tx,ty,tz,qx,qy,qz,qw`` or the
  16 row-major entries of the 4x4 ``fusion_T_camera`` matrix (an optional
  leading frame-name/index column is skipped automatically).
"""

from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np

from ..io import pcd as pcd_io
from ..io import ply as ply_io
from .decode import CloudFrame, make_cloud_frame
from .sources import ReplaySource

_POSE_NAMES = ("poses.tum", "trajectory.tum", "poses.txt", "poses.csv")


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (qx, qy, qz, qw) -> 3x3 rotation matrix."""
    x, y, z, w = (float(v) for v in q)
    n = (x * x + y * y + z * z + w * w) ** 0.5
    if n == 0:
        raise ValueError("zero quaternion in trajectory")
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.asarray([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def _pose_from_tq(t: np.ndarray, q: np.ndarray) -> np.ndarray:
    pose = np.eye(4, dtype=np.float64)
    pose[:3, :3] = quat_to_matrix(q)
    pose[:3, 3] = t
    return pose


def read_tum_trajectory(path: str) -> List[np.ndarray]:
    """TUM lines ``timestamp tx ty tz qx qy qz qw`` -> list of 4x4 poses."""
    poses = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.replace(",", " ").split()]
            if len(v) != 8:
                raise ValueError(
                    f"{path}: expected 8 TUM fields, got {len(v)}: {line!r}")
            poses.append(_pose_from_tq(np.asarray(v[1:4]),
                                       np.asarray(v[4:8])))
    return poses


def read_pose_csv(path: str) -> List[np.ndarray]:
    """CSV rows of tx,ty,tz,qx,qy,qz,qw or 16 row-major matrix entries;
    a non-numeric leading column (frame name) and a header row are
    tolerated and skipped."""
    poses = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            cells = [c.strip() for c in line.split(",") if c.strip() != ""]
            vals = []
            for i, c in enumerate(cells):
                try:
                    vals.append(float(c))
                except ValueError:
                    if i == 0:
                        continue           # frame-name column
                    vals = None            # header row
                    break
            if not vals:
                continue
            if len(vals) == 7:
                poses.append(_pose_from_tq(np.asarray(vals[0:3]),
                                           np.asarray(vals[3:7])))
            elif len(vals) == 16:
                poses.append(np.asarray(vals, np.float64).reshape(4, 4))
            elif len(vals) == 8:           # timestamp-prefixed TUM-in-CSV
                poses.append(_pose_from_tq(np.asarray(vals[1:4]),
                                           np.asarray(vals[4:8])))
            else:
                raise ValueError(
                    f"{path}: pose row needs 7 (t+quat), 8 (stamped) or "
                    f"16 (matrix) numbers, got {len(vals)}: {line!r}")
    return poses


def _unpack_rgb_float(packed_f32: np.ndarray) -> np.ndarray:
    p = packed_f32.astype(np.float32).view(np.uint32)
    return np.stack([(p >> 16) & 0xFF, (p >> 8) & 0xFF, p & 0xFF],
                    axis=1).astype(np.float32)


def load_frame_file(path: str) -> CloudFrame:
    """One PCD/PLY file -> CloudFrame (camera-frame points + optional rgb)."""
    if path.endswith(".ply"):
        d = ply_io.read_ply(path)
        xyz = d["xyz"].astype(np.float32)
        rgb = d.get("rgb")
    elif path.endswith(".pcd"):
        fields, _ = pcd_io.read_pcd(path)
        xyz = np.stack([fields["x"], fields["y"], fields["z"]],
                       axis=1).astype(np.float32)
        rgb = (_unpack_rgb_float(fields["rgb"])
               if "rgb" in fields else None)
    else:
        raise ValueError(f"unsupported frame format: {path}")
    return make_cloud_frame(xyz, rgb,
                            frame_id=os.path.basename(path))


def load_capture(directory: str) -> ReplaySource:
    """Directory of PCD/PLY frames + pose trajectory -> ReplaySource."""
    frame_paths = sorted(
        glob.glob(os.path.join(directory, "*.pcd"))
        + glob.glob(os.path.join(directory, "*.ply")))
    if not frame_paths:
        raise FileNotFoundError(f"no .pcd/.ply frames in {directory}")
    pose_path = None
    for name in _POSE_NAMES:
        p = os.path.join(directory, name)
        if os.path.exists(p):
            pose_path = p
            break
    if pose_path is None:
        raise FileNotFoundError(
            f"no pose file in {directory} (looked for {_POSE_NAMES})")
    if pose_path.endswith(".csv"):
        poses = read_pose_csv(pose_path)
    else:
        poses = read_tum_trajectory(pose_path)
    if len(poses) != len(frame_paths):
        raise ValueError(
            f"{len(frame_paths)} frames but {len(poses)} poses in "
            f"{directory}")
    frames = [load_frame_file(p) for p in frame_paths]
    return ReplaySource(frames, poses)
