"""The traffic generator at a tiny size: the same seed gives the same
inputs, any whole number is a seed, every pixel is valid, and the
PointCloud2 records hold each frame's camera points and colour."""

import numpy as np
import torch

from fusionbench.frozen import records
from fusionbench.frozen.synthetic import camera_rays, make_depth_sweep
from fusionbench.harness import registry
from fusionbench.harness.traffic import make_inputs
from fusionbench.tests import tiny

BBOX = (-0.35, 0.35, -0.35, 0.35, 0.0, 0.4)


def sweep(seed, frames=4):
    return make_depth_sweep(BBOX, frames, tiny.W, tiny.H, tiny.FX,
                            seed=seed, arc_frames=100)


def test_seeded():
    a, b, c = sweep(7), sweep(7), sweep(8)
    assert np.array_equal(a.depth_q, b.depth_q)
    assert np.array_equal(a.rgb565, b.rgb565)
    assert not np.array_equal(a.depth_q, c.depth_q)
    assert np.array_equal(a.poses, c.poses)       # sizes and poses alike


def test_large_and_negative_seeds():
    for seed in (2 ** 31 + 5, 2 ** 40, -3):
        s = sweep(seed, 1)
        assert s.depth_q.shape == (1, tiny.W * tiny.H)


def test_every_pixel_valid_and_inside_the_clip():
    s = sweep(3)
    z = s.depth_q.astype(np.float64) * 2.0 ** -16
    assert (s.depth_q > 0).all()
    assert ((z > 0.28) & (z < 0.6)).all()


def test_rays():
    r = camera_rays(4, 2, fx=2.0, fy=2.0, scale=1.0)
    assert r.shape == (3, 8) and np.all(r[2] == 1.0)
    assert r[0, 0] == -0.75 and r[1, 0] == -0.25


def test_records_hold_the_points():
    s = sweep(9, 2)
    blocks = records.cloud_records(s.depth_q, s.rgb565, s.srays)
    for f, b in enumerate(blocks):
        rec = np.frombuffer(b, np.float32).reshape(-1, 4)
        assert np.array_equal(rec[:, :3],
                              records.camera_points(s.depth_q[f], s.srays))
        w = rec[:, 3].view(np.uint32)
        col = np.stack([(w >> 16) & 255, (w >> 8) & 255, w & 255], axis=1)
        assert np.array_equal(col, records.rgb8(s.rgb565[f]))


def test_each_traffic_makes_inputs():
    bench = registry.benchmark()
    for w in bench["workloads"]:
        _, _, cfg, tr, _ = tiny.cell(w["name"])
        inp = make_inputs(tr, cfg, 1, "cpu")
        assert inp.frames == tiny.FRAMES
        assert inp.points_per_cycle == tiny.FRAMES * tiny.W * tiny.H
        pc, rgb, pose = next(inp.reference_frames("cpu"))
        assert pc.shape == (tiny.W * tiny.H, 3) and pose.shape == (4, 4)
        assert rgb.dtype == torch.float32
        if tr["wire"] == "pc2":
            assert len(inp.clouds) == tiny.FRAMES


def test_traffic_holds_the_mix_alone():
    """The camera is the configuration's; a mix names its wire, frames,
    arc, step kind and traced cycles."""
    for w in registry.benchmark()["workloads"]:
        tr = registry.traffic(w["traffic"])
        assert set(tr) == {"wire", "frames_per_scan", "arc_frames", "step",
                           "trace_cycles", "why"}
        assert registry.module("steps", tr["step"]).BATCH_FILL_WAIT > 0
