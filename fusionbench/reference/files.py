"""Plain readers of the files a scan writes: the ASCII or binary PCD of
PCL's PointXYZRGBNormal and the reference node's metadata CSV
(``Id,sdx,sdy,sdz,mean distance from normal, distance from normal sd,
points in cylinder``)."""

from __future__ import annotations

import io
import warnings

import numpy as np


def read_pcd(path: str) -> dict:
    """``{field: (n,) f32}`` of a PCD with 4-byte float fields, and
    ``rgb`` unpacked to (n,3) 8-bit channels."""
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.index(b"\n", raw.index(b"DATA "))
    head = {}
    for line in raw[:end].decode().splitlines():
        parts = line.split()
        if parts and not parts[0].startswith("#"):
            head[parts[0]] = parts[1:]
    fields = head["FIELDS"]
    n = int(head["POINTS"][0])
    body = raw[end + 1:]
    if head["DATA"][0] == "ascii":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # a file of no rows
            arr = np.loadtxt(io.BytesIO(body), dtype=np.float32,
                             ndmin=2).reshape(n, len(fields))
    else:
        arr = np.frombuffer(body, "<f4", count=n * len(fields)).reshape(
            n, len(fields))
    out = {f: arr[:, i].copy() for i, f in enumerate(fields)}
    if "rgb" in out:
        w = out["rgb"].view(np.uint32)
        out["rgb"] = np.stack([(w >> 16) & 0xFF, (w >> 8) & 0xFF, w & 0xFF],
                              axis=1).astype(np.float64)
    out["n"] = n
    return out


def read_csv(path: str) -> dict:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)     # a file of no rows
        data = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
    if not data.size:
        data = data.reshape(0, 7)
    return {"id": data[:, 0].astype(np.int64), "sd": data[:, 1:4],
            "mean_dist": data[:, 4], "sd_dist": data[:, 5],
            "count": data[:, 6].astype(np.int64), "n": data.shape[0]}
