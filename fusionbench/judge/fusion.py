"""The occupancy fusion judged against ``reference/fusion.py``.

The program's extract (or, where the step wrote them, its files read back)
is matched to the reference's by cell id.  The numbers, each a share or a
widest gap, are what ``limits/<cell>.json`` holds limits for:

* ``cells_symdiff``: cells only one side emits, over the reference's;
* ``count_flips``, ``npts_flips``: common cells whose cylinder count or
  raw count differs, over the common cells;
* ``count_total_rel``: the relative gap of the summed cylinder counts;
* over the common cells whose cylinder counts agree and whose normals
  agree to ``NORMAL_SAME`` (both tested nearly the same axis):
  ``centroid_gap_um``, the widest centroid gap; ``stats_gap_um``, the
  widest gap of the mean distance from the axis and of the square roots
  of the variances (per axis and of the distance);
* ``rgb_off``: the common cells whose raw counts agree and whose mean
  colours differ by more than 1e-3 (8-bit units), over those cells (the
  PCD's colour is truncated to whole units, so the reference's is too);
* ``normal_off``: common cells whose normals differ by more than 1e-3 in
  ``1 - n.n'``, over the common cells;
* ``file_rows`` (files only): rows of the PCD and the CSV that are not
  one a cell of the extract ``process()`` returned.
"""

from __future__ import annotations

import numpy as np
import torch

from fusionbench.judge import common
from fusionbench.reference import fusion as plain

# normals this close (in |n - n'|) count as one axis: an ill-conditioned
# window's normals turn by more under any change of rounding and put
# other points in the cylinder
NORMAL_SAME = 0.05


def reference(cfg: dict, inputs, device, ftype=torch.float32,
              acc=torch.float64) -> dict:
    """The plain reference over the run's sweep, on ``device``."""
    return plain.run_sweep(cfg["fusion_config"],
                           inputs.reference_frames(device), device, ftype,
                           acc)


def program_extract(out: dict) -> tuple:
    """The program's emitted cells as the judge reads them, and
    ``file_rows`` when files were written."""
    host = out["host"]
    if "pcd" not in out:
        return host, None
    pcd, csv = out["pcd"], out["csv"]
    n = int(host["cell"].shape[0])
    rows = abs(pcd["n"] - n) + abs(csv["n"] - n) + int(
        np.any(csv["id"] != np.arange(csv["n"])))
    if pcd["n"] != n or csv["n"] != n:
        return host, rows
    got = {
        "cell": host["cell"],
        "centroid": np.stack([pcd["x"], pcd["y"], pcd["z"]], axis=1),
        "normal": np.stack([pcd["normal_x"], pcd["normal_y"],
                            pcd["normal_z"]], axis=1),
        "rgb": pcd["rgb"], "rgb_truncated": True,
        "sd": csv["sd"], "mean_dist": csv["mean_dist"],
        "sd_dist": csv["sd_dist"], "count": csv["count"],
        "n_pts": host["n_pts"],
    }
    return got, rows


def numbers(out: dict, ref: dict, meta: dict) -> dict:
    got, rows = program_extract(out)
    nums = common.program_counts(meta, out["grid_metrics"])
    if rows is not None:
        nums["file_rows"] = rows
    cm, ia, ib = common.match(got["cell"], ref["cell"])
    n_ref = ref["cell"].shape[0]
    nums["cells_symdiff"] = common.share(
        got["cell"].shape[0] + n_ref - 2 * cm.size, n_ref)
    ca = np.asarray(got["count"], np.int64)[ia]
    cb = np.asarray(ref["count"], np.int64)[ib]
    pa = np.asarray(got["n_pts"], np.int64)[ia]
    pb = np.asarray(ref["n_pts"], np.int64)[ib]
    nums["count_flips"] = common.share((ca != cb).sum(), cm.size)
    nums["npts_flips"] = common.share((pa != pb).sum(), cm.size)
    nums["count_total_rel"] = abs(int(ca.sum()) - int(cb.sum())) / max(
        int(cb.sum()), 1)
    f64 = np.float64

    def rows_of(d, key):
        return np.asarray(d[key], f64)

    na, nb = rows_of(got, "normal")[ia], rows_of(ref, "normal")[ib]
    turn = np.linalg.norm(na - nb, axis=1)
    same = (ca == cb) & (turn <= NORMAL_SAME)

    ga = {k: rows_of(got, k)[ia][same] for k in
          ("centroid", "sd", "mean_dist", "sd_dist")}
    gb = {k: rows_of(ref, k)[ib][same] for k in ga}
    nums["centroid_gap_um"] = 1e6 * common.max_or0(
        np.linalg.norm(ga["centroid"] - gb["centroid"], axis=1))

    def root(x):
        return np.sqrt(np.maximum(x, 0.0))

    gaps = [np.abs(ga["mean_dist"] - gb["mean_dist"]),
            np.abs(root(ga["sd_dist"]) - root(gb["sd_dist"]))]
    gaps += [np.abs(root(ga["sd"][:, a]) - root(gb["sd"][:, a]))
             for a in range(3)]
    nums["stats_gap_um"] = 1e6 * max(common.max_or0(g) for g in gaps)
    # colour is the raw points' mean: judged where the raw counts agree
    raw = pa == pb
    ra, rb = rows_of(got, "rgb")[ia][raw], rows_of(ref, "rgb")[ib][raw]
    if got.get("rgb_truncated"):
        rb = np.floor(np.clip(rb, 0, 255))
    nums["rgb_off"] = common.share(
        (np.abs(ra - rb).max(axis=1, initial=0.0) > 1e-3).sum(), raw.sum())
    nums["normal_off"] = common.share((1.0 - np.sum(na * nb, axis=1)
                                       > 1e-3).sum(), cm.size)
    return nums
