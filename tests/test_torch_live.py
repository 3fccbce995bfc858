"""Live sessions of the port on the CPU, modelled on
``tests/test_live_pacing.py``: ``live_batching`` (a K-batch only when the
queue already holds one at a K-aligned frame, never a wait) gives the
single-stepped session's cells and counts; an idle queue still
single-steps; a paced run after ``warm()`` drops nothing."""

import time

import numpy as np
import pytest

from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.runtime.session import FusionSession
from hifi_fusion_tpu_torch.utils.synthetic import camera_rays, make_depth_sweep

W, H = 64, 48
KW = dict(max_points=W * H, z_clip=(0.05, 3.0), refine_every=4,
          max_batch_frames=4)
CFG = small_test_config(**KW)
RAYS = camera_rays(W, H, fx=60.0, fy=60.0)
FRAMES = make_depth_sweep(CFG, 12, width=W, height=H, srays=RAYS, seed=3,
                          camera_height=0.3)


def _burst(session, frames=FRAMES):
    """Warm, then push the whole sweep at once (the worst backlog)."""
    with session as s:
        s.warm(rays=RAYS)
        s.start()
        for f in frames:
            assert s.push_depth_frame(f.depth_q, f.rgb565, f.pose,
                                      rays=RAYS)
        assert s.drain(300)
        m = s.metrics()
        assert m["frames_integrated"] == len(frames)
        assert m["frames_dropped_backpressure"] == 0
        return s.process(extra_fields=("cell", "count", "n_pts")), m


@pytest.fixture(scope="module")
def bursts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("live")
    return {
        "single": _burst(FusionSession(CFG, "cpu",
                                       output_dir=str(tmp / "s"))),
        "batched": _burst(FusionSession(CFG, "cpu", live_batching=True,
                                        output_dir=str(tmp / "b"))),
    }


def test_live_batching_matches_single_step(bursts):
    (single, ms), (batched, mb) = bursts["single"], bursts["batched"]
    assert batched["n_points"] == single["n_points"] > 50
    for f in ("cell", "count", "n_pts"):
        np.testing.assert_array_equal(batched["host"][f],
                                      single["host"][f], err_msg=f)
    # the backlog drained in K-batches: fewer dispatches than frames
    assert ms["stage_timers"]["device_step"]["count"] == len(FRAMES)
    assert mb["stage_timers"]["device_step"]["count"] < len(FRAMES)


def test_live_batching_idle_queue_single_steps(tmp_path):
    """One frame on an idle queue is stepped at once: no wait for a
    batch (the fill wait belongs to ``batch_fill_wait`` alone)."""
    with FusionSession(CFG, "cpu", live_batching=True,
                       output_dir=str(tmp_path)) as s:
        s.warm(rays=RAYS)
        s.start()
        t0 = time.monotonic()
        f = FRAMES[0]
        s.push_depth_frame(f.depth_q, f.rgb565, f.pose, rays=RAYS)
        assert s.drain(timeout=30)
        dt = time.monotonic() - t0
        m = s.metrics()
    assert m["frames_integrated"] == 1
    assert m["stage_timers"]["device_step"]["count"] == 1
    assert dt < 5.0


def test_paced_live_session_zero_drops(tmp_path):
    """Paced arrivals at 4x the measured step ride the queue through the
    refine marks with zero backpressure drops."""
    with FusionSession(CFG, "cpu", live_batching=True, queue_depth=100,
                       output_dir=str(tmp_path)) as s:
        assert s.warm(rays=RAYS) > 0.0
        s.start()
        t0 = time.monotonic()
        for f in FRAMES[:4]:
            s.push_depth_frame(f.depth_q, f.rgb565, f.pose, rays=RAYS)
        assert s.drain(300)
        period = max((time.monotonic() - t0) / 4 * 4, 0.005)
        for f in FRAMES[4:]:
            t_next = time.monotonic() + period
            s.push_depth_frame(f.depth_q, f.rgb565, f.pose, rays=RAYS)
            time.sleep(max(t_next - time.monotonic(), 0.0))
        assert s.drain(300)
        m = s.metrics()
    assert m["frames_integrated"] == len(FRAMES)
    assert m["frames_dropped_backpressure"] == 0
    assert m["pose_failures"] == 0
