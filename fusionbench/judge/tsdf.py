"""The TSDF family judged against ``reference/tsdf.py``.

The program's surface extract (``process()``'s host dict: ``count`` the
rounded weight, ``mean_dist`` the TSDF value) is matched to the
reference's by cell id.  The numbers, each a share, a widest gap or a
relative count, are what ``limits/<cell>.json`` holds limits for:

* ``cells_symdiff``: surface cells only one side emits, over the
  reference's;
* ``weight_flips``: common cells whose rounded weights differ, over the
  common cells;
* ``tsdf_gap_um``: the widest gap of the TSDF value over the common cells
  (a sample more or less moves a mean of thousands by little, so no cell
  is left out for its weight);
* ``rgb_off``: common cells whose mean colours differ by more than 1e-3
  (8-bit units), over the common cells;
* ``centroid_gap_um``: the widest centroid gap over the common cells whose
  normals agree to ``NORMAL_SAME`` (a normal turns with any change of
  rounding where the gradient is nearly flat, and moves the centroid with
  it);
* ``normal_off``: common cells whose normals differ by more than 1e-3 in
  ``1 - n.n'``, over the common cells;
* ``unique_rel``: the gap between the program's ``unique_cells`` (the
  distinct cells its batches kept) and the reference's sum of the distinct
  cells of each K-frame batch, over the latter.  Both are whole numbers
  and must be equal.  A program that reports no such counter cannot be
  judged, and the judge raises.
"""

from __future__ import annotations

import numpy as np
import torch

from fusionbench.judge import common
from fusionbench.reference import tsdf as plain

NORMAL_SAME = 0.05


def reference(cfg: dict, inputs, device, ftype=torch.float32,
              acc=torch.float64) -> dict:
    """The plain reference over the run's sweep, on ``device``."""
    return plain.run_sweep(cfg, inputs.reference_frames(device), device,
                           ftype, acc)


def program_unique(out: dict) -> int:
    """The program's count of the cells its batches kept: its grid's
    ``unique_cells``, or, for a reference put in the program's place (the
    control), the count that reference made of its own work."""
    for where in (out.get("grid_metrics", {}), out["host"]):
        if "unique_cells" in where:
            return int(where["unique_cells"])
    raise KeyError("the program reports no unique_cells: the TSDF cell "
                   "compares its count of distinct cells with the "
                   "reference's")


def numbers(out: dict, ref: dict, meta: dict) -> dict:
    got = out["host"]
    nums = common.program_counts(meta, out["grid_metrics"])
    cm, ia, ib = common.match(got["cell"], ref["cell"])
    n_ref = ref["cell"].shape[0]
    nums["cells_symdiff"] = common.share(
        got["cell"].shape[0] + n_ref - 2 * cm.size, n_ref)
    wa = np.asarray(got["count"], np.int64)[ia]
    wb = np.asarray(ref["count"], np.int64)[ib]
    nums["weight_flips"] = common.share((wa != wb).sum(), cm.size)
    f64 = np.float64

    def rows(d, key, idx):
        return np.asarray(d[key], f64)[idx]

    nums["tsdf_gap_um"] = 1e6 * common.max_or0(np.abs(
        rows(got, "mean_dist", ia) - rows(ref, "mean_dist", ib)))
    na, nb = rows(got, "normal", ia), rows(ref, "normal", ib)
    same = np.linalg.norm(na - nb, axis=1) <= NORMAL_SAME
    nums["centroid_gap_um"] = 1e6 * common.max_or0(np.linalg.norm(
        rows(got, "centroid", ia) - rows(ref, "centroid", ib), axis=1)[same])
    nums["rgb_off"] = common.share((np.abs(
        rows(got, "rgb", ia) - rows(ref, "rgb", ib)).max(
            axis=1, initial=0.0) > 1e-3).sum(), cm.size)
    nums["normal_off"] = common.share((1.0 - np.sum(na * nb, axis=1)
                                       > 1e-3).sum(), cm.size)
    want = int(ref["unique_cells"])
    nums["unique_rel"] = abs(program_unique(out) - want) / max(want, 1)
    return nums
