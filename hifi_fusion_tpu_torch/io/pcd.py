"""PCD and metadata-CSV export and import for ``process()``.

A copy of ``hifi_fusion_tpu/io/pcd.py``, byte for byte in output: ASCII
(or binary) PCL PointXYZRGBNormal and PointXYZRGB PCDs, and the
reference's metadata CSV (OccupancyGrid.hpp:456-488).  The ASCII tables
and the CSV are formatted by the native host runtime (``runtime/native``:
``%.9g`` per PCD value, ``%.6g`` per CSV value), as the JAX package's are
when its library is built; a failed build raises.  ``_write_pcd_ascii_numpy``
and ``_write_metadata_csv_numpy`` are the NumPy formats the JAX package
writes without its library: the format oracles the tests hold the library
to.  Binary PCDs are NumPy ``tobytes`` in both packages.
"""

from __future__ import annotations

import io as _io
from typing import Dict, Tuple

import numpy as np

from ..runtime import native

_PCD_XYZ = ("x", "y", "z")
_PCD_NORMAL = ("normal_x", "normal_y", "normal_z")

# CSV header text matches the reference's metadata file byte-for-byte
# (OccupancyGrid.hpp:462).
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


def _header(fields, n: int, data_kind: str) -> str:
    k = len(fields)
    return "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        "FIELDS " + " ".join(fields),
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
    fields = _PCD_XYZ + ("rgb",) + _PCD_NORMAL + ("curvature",)
    cols = np.empty((n, 8), np.float32)
    cols[:, 0:3] = xyz.astype(np.float32)
    cols[:, 3] = _pack_rgb_float(rgb) if rgb is not None else 0.0
    cols[:, 4:7] = normal.astype(np.float32)
    cols[:, 7] = 0.0
    _write(path, _header(fields, n, "ascii" if ascii_mode else "binary"),
           cols, ascii_mode)


def write_pcd_xyzrgb(path: str, xyz: np.ndarray, rgb: np.ndarray,
                     ascii_mode: bool = True) -> None:
    """PCL-layout PointXYZRGB PCD (fields x y z rgb)."""
    n = xyz.shape[0]
    cols = np.empty((n, 4), np.float32)
    cols[:, 0:3] = xyz.astype(np.float32)
    cols[:, 3] = _pack_rgb_float(rgb) if rgb is not None else 0.0
    _write(path, _header(_PCD_XYZ + ("rgb",), n,
                         "ascii" if ascii_mode else "binary"),
           cols, ascii_mode)


def _write(path: str, hdr: str, cols: np.ndarray, ascii_mode: bool) -> None:
    if ascii_mode:
        native.write_pcd_ascii(path, hdr, cols)
    else:
        with open(path, "wb") as f:
            f.write(hdr.encode())
            f.write(np.ascontiguousarray(cols, "<f4").tobytes())


def _write_pcd_ascii_numpy(path: str, hdr: str, cols: np.ndarray) -> None:
    """The NumPy format of an ASCII PCD table (the JAX package's writer
    without its library)."""
    with open(path, "w") as f:
        f.write(hdr)
        np.savetxt(f, cols, fmt="%.9g", delimiter=" ")


def read_pcd(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """Minimal PCD reader (ascii/binary, float32 scalar fields only)."""
    with open(path, "rb") as f:
        raw = f.read()
    head_end = raw.find(b"DATA ")
    nl = raw.find(b"\n", head_end)
    header_txt = raw[:nl].decode()
    body = raw[nl + 1:]
    meta = {}
    for line in header_txt.splitlines():
        parts = line.split()
        if parts:
            meta[parts[0]] = parts[1:]
    fields = meta["FIELDS"]
    n = int(meta["POINTS"][0])
    kind = meta["DATA"][0]
    k = len(fields)
    if kind == "ascii":
        arr = np.loadtxt(_io.BytesIO(body), dtype=np.float32,
                         ndmin=2).reshape(n, k)
    else:
        arr = np.frombuffer(body, "<f4", count=n * k).reshape(n, k)
    return {f: arr[:, i].copy() for i, f in enumerate(fields)}, n


def _csv_columns(sd, mean_dist, sd_dist) -> np.ndarray:
    n = sd.shape[0]
    cols = np.empty((n, 5), np.float64)
    cols[:, 0:3] = sd
    cols[:, 3] = mean_dist
    cols[:, 4] = sd_dist
    return cols


def write_metadata_csv(path: str, sd: np.ndarray, mean_dist: np.ndarray,
                       sd_dist: np.ndarray, count: np.ndarray) -> None:
    """One row per voxel: id, per-axis sd, mean and sd of the distance from
    the normal axis, points in the cylinder."""
    native.write_metadata_csv(path, CSV_HEADER,
                              _csv_columns(sd, mean_dist, sd_dist),
                              np.asarray(count).astype(np.int64))


def _write_metadata_csv_numpy(path: str, sd: np.ndarray,
                              mean_dist: np.ndarray, sd_dist: np.ndarray,
                              count: np.ndarray) -> None:
    """The NumPy format of the metadata CSV (the JAX package's writer
    without its library)."""
    cols = _csv_columns(sd, mean_dist, sd_dist)
    with open(path, "w") as f:
        f.write(CSV_HEADER + "\n")
        for i in range(cols.shape[0]):
            f.write(f"{i},{cols[i,0]:.6g},{cols[i,1]:.6g},{cols[i,2]:.6g},"
                    f"{cols[i,3]:.6g},{cols[i,4]:.6g},{int(count[i])}\n")


def read_metadata_csv(path: str) -> Dict[str, np.ndarray]:
    data = np.genfromtxt(path, delimiter=",", skip_header=1, ndmin=2)
    return {
        "id": data[:, 0].astype(np.int64),
        "sd": data[:, 1:4],
        "mean_dist": data[:, 4],
        "sd_dist": data[:, 5],
        "count": data[:, 6].astype(np.int64),
    }
