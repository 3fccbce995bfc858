"""The slice as a whole: the port's FusionSession against the JAX
package's on one seeded 8-frame depth sweep (K=4 batches, a refine every
4 frames, final refine, extract, PCD and CSV export).

The extracts must hold the same cells with the same cylinder counts;
centroids and normals agree within 1e-5.  Both sessions write files that
parse, and report the same grid-metric keys with every overflow at zero.
"""

import os

import numpy as np
import pytest

from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.io.pcd import read_metadata_csv, read_pcd
from hifi_fusion_tpu.runtime.session import FusionSession as JaxSession
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.models.pipeline import refine_due
from hifi_fusion_tpu_torch.runtime.session import FusionSession, batch_frames
from hifi_fusion_tpu_torch.utils.synthetic import camera_rays, make_depth_sweep

KW = dict(refine_every=4, max_batch_frames=4, z_clip=(0.05, 10.0))
CFG = small_test_config(**KW)
JCFG = jax_config(**KW)
RAYS = camera_rays(64, 64, fx=80.0, fy=80.0)
FRAMES = make_depth_sweep(CFG, 8, width=64, height=64, srays=RAYS, seed=0,
                          noise_sd=3e-4, camera_height=0.4)
FIELDS = ("cell", "count", "centroid", "normal", "mean_dist")


def _run(session, out, **process_kw):
    with session(output_dir=out, queue_depth=64, batch_fill_wait=2.0) as s:
        s.start()
        for f in FRAMES:
            assert s.push_depth_frame(f.depth_q, f.rgb565, f.pose,
                                      rays=RAYS)
        assert s.drain(600)
        assert s.metrics()["frames_integrated"] == len(FRAMES)
        return s.process(ascii_mode=True, **process_kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sessions")
    port = _run(lambda **kw: FusionSession(CFG, "cpu", **kw),
                str(tmp / "port"))
    ref = _run(lambda **kw: JaxSession(JCFG, **kw), str(tmp / "jax"),
               extra_fields=FIELDS)
    return port, ref


def test_session_extract_matches_jax(runs):
    port, ref = runs
    a, b = port["host"], ref["host"]
    assert port["n_points"] == ref["n_points"] > 500
    np.testing.assert_array_equal(a["cell"], b["cell"])
    np.testing.assert_array_equal(a["count"], b["count"])
    assert a["count"].sum() > 0
    np.testing.assert_allclose(a["centroid"], b["centroid"], atol=1e-5)
    np.testing.assert_allclose(a["normal"], b["normal"], atol=1e-5)
    np.testing.assert_allclose(a["mean_dist"], b["mean_dist"], atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(a["normal"], axis=1), 1.0,
                               atol=1e-5)


def test_session_files_and_metrics(runs):
    port, ref = runs
    assert set(port["grid_metrics"]) == set(ref["grid_metrics"])
    assert len(port["grid_metrics"]) == 16
    for k, v in port["grid_metrics"].items():
        if k.startswith("overflow"):
            assert v == 0 == ref["grid_metrics"][k], k
    assert os.path.basename(port["cloud"]) == "test_cloud.pcd"
    assert os.path.basename(port["metadata"]) == "meta.csv"
    cloud, n = read_pcd(port["cloud"])
    want, _ = read_pcd(ref["cloud"])
    assert n == port["n_points"]
    for f in ("x", "y", "z", "normal_x", "normal_y", "normal_z"):
        np.testing.assert_allclose(cloud[f], want[f], atol=1e-5)
    np.testing.assert_array_equal(cloud["rgb"].view(np.uint32),
                                  want["rgb"].view(np.uint32))
    meta = read_metadata_csv(port["metadata"])
    np.testing.assert_array_equal(meta["count"], port["host"]["count"])
    np.testing.assert_array_equal(meta["id"], np.arange(n))


def test_batch_rule_and_cadence():
    """K divides both refine marks' spacing and the first mark, and the
    cadence rule is the JAX package's."""
    from hifi_fusion_tpu.models.pipeline import refine_due as jax_due
    for every, first, kmax in ((16, 0, 8), (12, 0, 8), (8, 12, 8),
                               (10, 4, 8), (0, 0, 8), (7, 0, 4)):
        cfg = small_test_config(refine_every=every, refine_first=first,
                                max_batch_frames=kmax)
        k = batch_frames(cfg)
        assert 1 <= k <= kmax
        if every:
            assert every % k == 0 and (first == 0 or first % k == 0)
            for f in range(1, 40):
                assert refine_due(f, k, cfg) == jax_due(f, k, cfg)
