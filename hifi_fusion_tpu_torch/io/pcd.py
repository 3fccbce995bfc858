"""PCD and metadata-CSV writers for ``process()`` (numpy only).

A copy of the writers in ``hifi_fusion_tpu/io/pcd.py``, kept byte-for-byte
in output: an ASCII (or binary) PCL PointXYZRGBNormal PCD of the
cylinder-filtered centroids, and the reference's metadata CSV.  Formatting
is numpy's (``%.9g`` per PCD value, ``%.6g`` per CSV value), which is what
the JAX package writes when its optional C++ writer is not built.
"""

from __future__ import annotations

import numpy as np

_PCD_FIELDS = ("x", "y", "z", "rgb", "normal_x", "normal_y", "normal_z",
               "curvature")

# CSV header text matches the reference's metadata file byte-for-byte.
CSV_HEADER = ("Id,sdx,sdy,sdz,mean distance from normal,"
              " distance from normal sd, points in cylinder")


def _pack_rgb_float(rgb: np.ndarray) -> np.ndarray:
    """(N,3) float 0-255 -> PCL packed-float rgb column (clip, truncate,
    pack 0x00RRGGBB, reinterpret as f32).  A 1-D integer ``rgb`` is taken
    as already-packed words."""
    if rgb.ndim == 1:
        return np.ascontiguousarray(rgb, np.uint32).view(np.float32)
    r = np.clip(rgb[:, 0], 0, 255).astype(np.uint32)
    g = np.clip(rgb[:, 1], 0, 255).astype(np.uint32)
    b = np.clip(rgb[:, 2], 0, 255).astype(np.uint32)
    packed = (r << 16) | (g << 8) | b
    return packed.view(np.float32)


def _header(n: int, data_kind: str) -> str:
    k = len(_PCD_FIELDS)
    return "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        "FIELDS " + " ".join(_PCD_FIELDS),
        "SIZE " + " ".join(["4"] * k),
        "TYPE " + " ".join(["F"] * k),
        "COUNT " + " ".join(["1"] * k),
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        f"DATA {data_kind}",
        "",
    ])


def write_pcd_xyzrgbnormal(path: str, xyz: np.ndarray, rgb: np.ndarray,
                           normal: np.ndarray, ascii_mode: bool = True
                           ) -> None:
    """PCL-layout PointXYZRGBNormal PCD (fields x y z rgb normal curvature)."""
    n = xyz.shape[0]
    hdr = _header(n, "ascii" if ascii_mode else "binary")
    cols = np.empty((n, 8), np.float32)
    cols[:, 0:3] = xyz.astype(np.float32)
    cols[:, 3] = _pack_rgb_float(rgb) if rgb is not None else 0.0
    cols[:, 4:7] = normal.astype(np.float32)
    cols[:, 7] = 0.0
    if ascii_mode:
        with open(path, "w") as f:
            f.write(hdr)
            np.savetxt(f, cols, fmt="%.9g", delimiter=" ")
    else:
        with open(path, "wb") as f:
            f.write(hdr.encode())
            f.write(np.ascontiguousarray(cols, "<f4").tobytes())


def write_metadata_csv(path: str, sd: np.ndarray, mean_dist: np.ndarray,
                       sd_dist: np.ndarray, count: np.ndarray) -> None:
    """One row per voxel: id, per-axis sd, mean and sd of the distance from
    the normal axis, points in the cylinder."""
    n = sd.shape[0]
    cols = np.empty((n, 5), np.float64)
    cols[:, 0:3] = sd
    cols[:, 3] = mean_dist
    cols[:, 4] = sd_dist
    with open(path, "w") as f:
        f.write(CSV_HEADER + "\n")
        for i in range(n):
            f.write(f"{i},{cols[i,0]:.6g},{cols[i,1]:.6g},{cols[i,2]:.6g},"
                    f"{cols[i,3]:.6g},{cols[i,4]:.6g},{int(count[i])}\n")
