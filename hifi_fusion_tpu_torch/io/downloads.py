"""Download variants: the full export API surface of the reference grid.

A copy of ``hifi_fusion_tpu/io/downloads.py`` (numpy only).

Mirrors every ``OccupancyGrid::download*`` entry point (survey §2 C16):

* ``download_data``       -> downloadData  (PCD XYZRGBNormal + metadata CSV,
                             OccupancyGrid.hpp:456-488)
* ``download_xyz``        -> download(PointXYZRGB)       (hpp:491-512)
* ``download_with_normals``-> download(PointXYZRGBNormal)(hpp:577-601)
* ``download_hq``         -> downloadHQ (count >= threshold, hpp:545-575)
* ``download_classified`` -> downloadClassified (red if count >
                             kGoodPointsThreshold else white, hpp:514-543)

All of them are thin host-side views over one extract (the host dict of
``FusionPipeline.extract_host``): the reference re-walks all ~63M dense
cells per variant; here each variant is a mask over the compacted arrays.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..config import FusionConfig
from . import pcd


def download_data(host: Dict[str, np.ndarray], cloud_path: str,
                  metadata_path: str, ascii_mode: bool = True) -> int:
    """The ``process`` deliverable: XYZRGBNormal PCD + per-voxel noise CSV."""
    pcd.write_pcd_xyzrgbnormal(cloud_path, host["centroid"], host["rgb"],
                               host["normal"], ascii_mode=ascii_mode)
    pcd.write_metadata_csv(metadata_path, host["sd"], host["mean_dist"],
                           host["sd_dist"], host["count"])
    return int(host["centroid"].shape[0])


def download_xyz(host: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    return {"xyz": host["centroid"].copy(), "rgb": host["rgb"].copy()}


def download_with_normals(host: Dict[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
    return {"xyz": host["centroid"].copy(), "rgb": host["rgb"].copy(),
            "normal": host["normal"].copy()}


def download_hq(host: Dict[str, np.ndarray], config: FusionConfig,
                threshold: Optional[float] = None) -> Dict[str, np.ndarray]:
    """Keep voxels with count >= threshold (reference skips count < thr)."""
    thr = config.good_points_threshold if threshold is None else threshold
    keep = host["count"] >= thr
    return {"xyz": host["centroid"][keep], "rgb": host["rgb"][keep],
            "normal": host["normal"][keep], "count": host["count"][keep]}


def download_classified(host: Dict[str, np.ndarray], config: FusionConfig
                        ) -> Dict[str, np.ndarray]:
    """White points, red where count > good_points_threshold (quality map)."""
    n = host["centroid"].shape[0]
    rgb = np.full((n, 3), 255.0, np.float32)
    good = host["count"] > config.good_points_threshold
    rgb[good, 1] = 0.0
    rgb[good, 2] = 0.0
    return {"xyz": host["centroid"].copy(), "rgb": rgb,
            "good": good}
