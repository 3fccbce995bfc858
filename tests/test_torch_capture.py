"""The port's copy of the recorded-capture reader (runtime/capture.py)
against the JAX package's: quaternions, the TUM and CSV trajectory readers
with their variants and errors, the frames and poses of a capture
directory (``tests/fixtures/capture``: two ASCII PCDs, one ASCII PLY and a
TUM trajectory, and one written here from a depth sweep), and the same
directory fused in both packages' sessions, held by cell id."""

import os

import numpy as np
import pytest

from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.io import pcd as jpcd
from hifi_fusion_tpu.runtime import capture as jcapture
from hifi_fusion_tpu.runtime.session import FusionSession as JaxSession
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.io import pcd
from hifi_fusion_tpu_torch.runtime import capture
from hifi_fusion_tpu_torch.runtime.session import FusionSession
from hifi_fusion_tpu_torch.utils.synthetic import camera_rays, make_depth_sweep

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "capture")
KW = dict(refine_every=2, max_batch_frames=2, z_clip=(0.05, 10.0))


@pytest.mark.parametrize("q", [[0, 0, 0, 1], [1, 0, 0, 0],
                               [0.1, -0.7, 0.3, 0.6], [2.0, 0.0, 0.0, 2.0]])
def test_quat_to_matrix_matches_jax(q):
    got = capture.quat_to_matrix(q)
    np.testing.assert_array_equal(got, jcapture.quat_to_matrix(q))
    np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-12)


def test_zero_quaternion_raises_in_both():
    for mod in (capture, jcapture):
        with pytest.raises(ValueError, match="zero quaternion"):
            mod.quat_to_matrix([0, 0, 0, 0])


TUM = ("# timestamp tx ty tz qx qy qz qw\n"
       "0.0 0.1 0.2 0.3 0 0 0 1\n"
       "\n"
       "0.5, -0.1, 0.0, 0.45, 1, 0, 0, 0\n"
       "1.0 0.0 0.05 0.5 0.1 -0.7 0.3 0.6\n")
CSVS = {
    "named": "frame,tx,ty,tz,qx,qy,qz,qw\nf0,0.1,0.2,0.3,0,0,0,1\n"
             "f1,0.2,0.2,0.3,1,0,0,0\n",
    "matrix": "1,0,0,0.5,0,-1,0,0.1,0,0,-1,0.4,0,0,0,1\n"
              "# a comment\n1,0,0,0.6,0,-1,0,0.1,0,0,-1,0.4,0,0,0,1\n",
    "stamped": "t,tx,ty,tz,qx,qy,qz,qw\n0.0,0,0,0.3,0,0,0,1\n",
}


def test_tum_trajectory_matches_jax(tmp_path):
    p = tmp_path / "poses.tum"
    p.write_text(TUM)
    got = capture.read_tum_trajectory(str(p))
    want = jcapture.read_tum_trajectory(str(p))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CSVS))
def test_pose_csv_variants_match_jax(tmp_path, name):
    p = tmp_path / "poses.csv"
    p.write_text(CSVS[name])
    got = capture.read_pose_csv(str(p))
    want = jcapture.read_pose_csv(str(p))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["no_frames", "no_poses", "count",
                                  "bad_tum", "bad_csv"])
def test_capture_errors_match_jax(tmp_path, case):
    """Each malformed directory raises the same error type in both."""
    d = tmp_path / case
    d.mkdir()
    frame = os.path.join(FIXTURE, "frame_0000.pcd")
    if case != "no_frames":
        (d / "frame_0000.pcd").write_bytes(open(frame, "rb").read())
    if case == "count":
        (d / "poses.tum").write_text(TUM)
    elif case == "bad_tum":
        (d / "poses.tum").write_text("0.0 0.1 0.2 0.3 0 0 1\n")
    elif case == "bad_csv":
        (d / "poses.csv").write_text("1,2,3,4,5\n")
    errors = []
    for mod in (capture, jcapture):
        with pytest.raises((FileNotFoundError, ValueError)) as e:
            mod.load_capture(str(d))
        errors.append(type(e.value))
    assert errors[0] is errors[1]


def test_load_capture_matches_jax():
    src, jsrc = capture.load_capture(FIXTURE), jcapture.load_capture(FIXTURE)
    assert len(src) == len(jsrc) == 3
    for (f, p), (jf, jp) in zip(src, jsrc):
        assert f.data == jf.data and f.frame_id == jf.frame_id
        assert f.point_step == jf.point_step and f.width == jf.width
        assert [(x.name, x.offset) for x in f.fields] == \
            [(x.name, x.offset) for x in jf.fields]
        np.testing.assert_array_equal(p, jp)


def write_capture(directory, frames, n_keep=None) -> None:
    """A capture directory of depth frames: each frame's valid camera
    points as a binary PCD (xyz and packed colour) and a CSV trajectory of
    16 matrix entries a row."""
    os.makedirs(directory, exist_ok=True)
    rows = []
    for i, f in enumerate(frames):
        keep = f.depth_q > 0
        xyz = np.ascontiguousarray(f.points_f32[:, keep].T)
        v = f.rgb565[keep].astype(np.uint32)
        rgb = np.stack([((v >> 11) & 0x1F) * 8, ((v >> 5) & 0x3F) * 4,
                        (v & 0x1F) * 8], axis=1).astype(np.float32)
        pcd.write_pcd_xyzrgb(os.path.join(directory, f"frame_{i:04d}.pcd"),
                             xyz[:n_keep], rgb[:n_keep], ascii_mode=False)
        rows.append(",".join(repr(float(x)) for x in f.pose.reshape(-1)))
    with open(os.path.join(directory, "poses.csv"), "w") as fh:
        fh.write("\n".join(rows) + "\n")


@pytest.mark.parametrize("source", ["fixture", "depth_sweep"])
def test_capture_fused_in_both_packages(tmp_path, source):
    """The same capture directory through ``run_source`` in both sessions
    (one step a frame, the JAX package's one program for both sources):
    the same cells and counts, centroids within 1e-5."""
    cfg, jcfg = small_test_config(**KW), jax_config(**KW)
    if source == "fixture":
        directory = FIXTURE
    else:
        rays = camera_rays(48, 40, fx=60.0, fy=60.0)
        directory = str(tmp_path / "capture")
        write_capture(directory, make_depth_sweep(
            cfg, 4, width=48, height=40, srays=rays, seed=8,
            camera_height=0.4))
    out = {}
    for name, make, mod in (
            ("port", lambda **kw: FusionSession(cfg, "cpu", **kw), capture),
            ("jax", lambda **kw: JaxSession(jcfg, **kw), jcapture)):
        with make(output_dir=str(tmp_path / name)) as s:
            s.run_source(mod.load_capture(directory))
            assert s.metrics()["frames_integrated"] == len(
                mod.load_capture(directory))
            out[name] = s.process(extra_fields=("cell", "count",
                                                "centroid"))
    a, b = out["port"]["host"], out["jax"]["host"]
    assert a["cell"].size > 20
    np.testing.assert_array_equal(a["cell"], b["cell"])
    np.testing.assert_array_equal(a["count"], b["count"])
    np.testing.assert_allclose(a["centroid"], b["centroid"], atol=1e-5)
    np.testing.assert_array_equal(
        pcd.read_metadata_csv(out["port"]["metadata"])["count"],
        jpcd.read_metadata_csv(out["jax"]["metadata"])["count"])
