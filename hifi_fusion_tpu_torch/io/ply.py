"""PLY export/import (ascii + binary_little_endian).

A copy of ``hifi_fusion_tpu/io/ply.py`` (numpy only), byte for byte in
output.  The reference links pcl's PLY I/O (FUSION.cpp:23), and "fused
PLY/PCD" are its deliverable formats; this is the PLY side, with the PCD
exports' schema: positions, colours and normals.  ``process()`` writes it
when the cloud's name ends in ``.ply``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def write_ply(path: str, xyz: np.ndarray, rgb: Optional[np.ndarray] = None,
              normal: Optional[np.ndarray] = None,
              ascii_mode: bool = False) -> None:
    n = xyz.shape[0]
    props = ["property float x", "property float y", "property float z"]
    if normal is not None:
        props += ["property float nx", "property float ny",
                  "property float nz"]
    if rgb is not None:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    header = "\n".join([
        "ply",
        "format " + ("ascii 1.0" if ascii_mode
                     else "binary_little_endian 1.0"),
        "comment generated by hifi_fusion_tpu",
        f"element vertex {n}",
        *props,
        "end_header",
    ]) + "\n"

    cols_f = [xyz.astype(np.float32)]
    if normal is not None:
        cols_f.append(normal.astype(np.float32))
    fdata = np.concatenate(cols_f, axis=1)
    cdata = (np.clip(rgb, 0, 255).astype(np.uint8)
             if rgb is not None else None)

    if ascii_mode:
        with open(path, "w") as f:
            f.write(header)
            for i in range(n):
                row = " ".join(f"{v:.9g}" for v in fdata[i])
                if cdata is not None:
                    row += " " + " ".join(str(int(v)) for v in cdata[i])
                f.write(row + "\n")
        return

    k = fdata.shape[1]
    dt = np.dtype([("f", "<f4", (k,))] if cdata is None else
                  [("f", "<f4", (k,)), ("c", "u1", (3,))])
    rec = np.empty(n, dt)
    rec["f"] = fdata
    if cdata is not None:
        rec["c"] = cdata
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())


def read_ply(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        raw = f.read()
    end = raw.find(b"end_header\n")
    header = raw[:end].decode().splitlines()
    body = raw[end + len(b"end_header\n"):]
    fmt = next(l.split()[1] for l in header if l.startswith("format"))
    n = int(next(l.split()[2] for l in header
                 if l.startswith("element vertex")))
    props = [(l.split()[1], l.split()[2]) for l in header
             if l.startswith("property")]
    fprops = [name for t, name in props if t in ("float", "float32")]
    cprops = [name for t, name in props if t in ("uchar", "uint8")]

    if fmt == "ascii":
        rows = np.loadtxt(body.decode().splitlines(), ndmin=2)
        vals = {name: rows[:, i] for i, name in
                enumerate(fprops + cprops)}
    else:
        dt = np.dtype([("f", "<f4", (len(fprops),))]
                      + ([("c", "u1", (len(cprops),))] if cprops else []))
        rec = np.frombuffer(body, dt, count=n)
        vals = {name: rec["f"][:, i] for i, name in enumerate(fprops)}
        for i, name in enumerate(cprops):
            vals[name] = rec["c"][:, i].astype(np.float64)

    out = {"xyz": np.stack([vals["x"], vals["y"], vals["z"]], axis=1)}
    if "nx" in vals:
        out["normal"] = np.stack([vals["nx"], vals["ny"], vals["nz"]],
                                 axis=1)
    if "red" in vals:
        out["rgb"] = np.stack([vals["red"], vals["green"], vals["blue"]],
                              axis=1)
    return out
