"""The session's host surface of the port against the JAX package's.

One seeded 6-frame 64x64 depth sweep (``small_test_config(refine_every=4,
max_batch_frames=2, z_clip=(0.05, 10.0))``: three K=2 batches, a refine
after the second, a final refine in ``process()``) runs through both
sessions, exporting a PLY, the metadata CSV and the four variants:

* the files have the JAX session's names; the PLY, the CSV and each
  variant hold the same rows, with positions and normals within 1e-5 and
  equal colours and counts;
* ``metrics()["stage_timers"]`` carries the JAX session's stage names
  (a planar replay adds ``decode``);
* F1: after a failed dispatch and ``reset(full=True)``, ``process()``
  exports the new grid, with the JAX session's cells;
* ``warm()`` leaves the grid empty, and a replay after it equals one
  without it; ``run_source`` equals a ``push_frame`` loop; the sweep
  files of ``runtime/sources`` load in either package;
* the lane-budget divergence by design: where the JAX package's batch
  lane budgets bind, it drops lanes and counts them in
  ``overflow_unique`` / ``overflow_hits``, while the port fuses every lane
  (its counters stay 0) and holds the JAX package's grid with unbound
  budgets.
"""

import dataclasses
import os

import numpy as np
import pytest

from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.io import pcd as jpcd
from hifi_fusion_tpu.io import ply as jply
from hifi_fusion_tpu.models.pipeline import FusionPipeline as JaxPipeline
from hifi_fusion_tpu.runtime import sources as jsources
from hifi_fusion_tpu.runtime.session import FusionSession as JaxSession
from hifi_fusion_tpu_torch import checks, convert
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.models.pipeline import FusionPipeline
from hifi_fusion_tpu_torch.runtime import sources
from hifi_fusion_tpu_torch.runtime.decode import make_cloud_frame
from hifi_fusion_tpu_torch.runtime.session import FusionSession
from hifi_fusion_tpu_torch.utils.synthetic import (camera_rays,
                                                   make_depth_sweep,
                                                   make_sweep)

KW = dict(refine_every=4, max_batch_frames=2, z_clip=(0.05, 10.0))
CFG = small_test_config(**KW)
JCFG = jax_config(**KW)
RAYS = camera_rays(64, 64, fx=80.0, fy=80.0)
FRAMES = make_depth_sweep(CFG, 6, width=64, height=64, srays=RAYS, seed=4,
                          noise_sd=3e-4, camera_height=0.4)
VARIANTS = ("hq", "classified", "xyzrgb", "normals")
FIELDS = ("cell", "count", "centroid", "normal", "mean_dist")
STAGES = {"device_step", "device_wait", "refine", "process_refine",
          "process_extract", "process_export", "process_csv_wait",
          "process_metrics", "process_clear"}


def _session(pkg, out, **kw):
    kw = {"output_dir": out, "batch_fill_wait": 2.0, **kw}
    if pkg == "port":
        return FusionSession(CFG, "cpu", **kw)
    return JaxSession(JCFG, **kw)


def _push(s, frames):
    for f in frames:
        assert s.push_depth_frame(f.depth_q, f.rgb565, f.pose, rays=RAYS)


def _replay(pkg, out, warm=False, **process_kw):
    with _session(pkg, out) as s:
        if warm:
            assert s.warm(RAYS, extract=True, depth=True) >= 0
            m = s.metrics()
            assert m["occupied_voxels"] == m["frames"] == 0
            assert m["slots_used"] == 0
        s.start()
        _push(s, FRAMES)
        assert s.drain(600)
        r = s.process(**process_kw)
        return r, s.metrics()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("surface")
    kw = dict(cloud_name="cloud.ply", variants=VARIANTS,
              extra_fields=FIELDS)
    return {pkg: _replay(pkg, str(tmp / pkg), **kw)
            for pkg in ("port", "jax")}


def test_process_files_match_jax(runs):
    (port, _), (ref, _) = runs["port"], runs["jax"]
    n = port["n_points"]
    assert n == ref["n_points"] > 300
    assert os.path.basename(port["cloud"]) == os.path.basename(ref["cloud"])
    assert {k: os.path.basename(v) for k, v in port["variants"].items()} \
        == {k: os.path.basename(v) for k, v in ref["variants"].items()}
    got, want = jply.read_ply(port["cloud"]), jply.read_ply(ref["cloud"])
    assert got["xyz"].shape == (n, 3)
    np.testing.assert_allclose(got["xyz"], want["xyz"], atol=1e-5)
    np.testing.assert_allclose(got["normal"], want["normal"], atol=1e-5)
    np.testing.assert_array_equal(got["rgb"], want["rgb"])
    got = jpcd.read_metadata_csv(port["metadata"])
    want = jpcd.read_metadata_csv(ref["metadata"])
    np.testing.assert_array_equal(got["id"], want["id"])
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_allclose(got["mean_dist"], want["mean_dist"],
                               atol=1e-5)
    for v in VARIANTS:
        got, gn = jpcd.read_pcd(port["variants"][v])
        want, wn = jpcd.read_pcd(ref["variants"][v])
        assert gn == wn and list(got) == list(want), v
        for f in got:
            if f == "rgb":
                np.testing.assert_array_equal(got[f], want[f], err_msg=v)
            else:
                np.testing.assert_allclose(got[f], want[f], atol=1e-5,
                                           err_msg=f"{v} {f}")
    assert 0 < wn


def test_process_host_matches_jax(runs):
    (port, _), (ref, _) = runs["port"], runs["jax"]
    assert set(port["host"]) == set(FIELDS) == set(ref["host"])
    np.testing.assert_array_equal(port["host"]["cell"], ref["host"]["cell"])
    np.testing.assert_array_equal(port["host"]["count"],
                                  ref["host"]["count"])
    np.testing.assert_allclose(port["host"]["centroid"],
                               ref["host"]["centroid"], atol=1e-5)


def test_stage_timer_names_match_jax(runs, tmp_path):
    (_, m), (_, jm) = runs["port"], runs["jax"]
    assert set(m["stage_timers"]) == set(jm["stage_timers"]) == STAGES
    for name, t in m["stage_timers"].items():
        assert set(t) == {"total_s", "count", "mean_ms"}
        assert t["count"] >= 1 and t["total_s"] >= 0.0, name
    assert m["stage_timers"]["device_step"]["count"] == 3
    # a planar replay adds the host decode
    sweep = make_sweep(CFG, 4, 500, seed=6)
    with FusionSession(CFG, "cpu", output_dir=str(tmp_path),
                       batch_fill_wait=2.0) as s:
        s.start()
        for f in sweep:
            assert s.push_frame(make_cloud_frame(f.points_cam, f.rgb),
                                f.pose)
        s.process()
        t = s.metrics()["stage_timers"]
    assert set(t) == STAGES - {"process_refine"} | {"decode"}
    assert t["decode"]["count"] == 2


def test_unknown_variant_raises(tmp_path):
    with FusionSession(CFG, "cpu", output_dir=str(tmp_path)) as s:
        with pytest.raises(ValueError, match="unknown export variant"):
            s.process(variants=("bogus",))
        # the session stays usable
        assert s.process()["n_points"] == 0


def _f1(pkg, out):
    """One frame with a (3,3) pose fails to dispatch; reset(full=True);
    four good frames; process()."""
    with _session(pkg, out, batch_fill_wait=0.0) as s:
        s.start()
        assert s.push_depth_frame(FRAMES[0].depth_q, FRAMES[0].rgb565,
                                  np.eye(3, dtype=np.float32), rays=RAYS)
        assert s.drain(600)
        if pkg == "port":
            assert s.metrics()["dispatch_errors"] == 1
        s.reset(full=True)
        s.start()
        _push(s, FRAMES[1:5])
        assert s.drain(600)
        r = s.process(extra_fields=FIELDS)
        if pkg == "port":
            m = s.metrics()
            assert m["frames_integrated"] == 4
            assert m["dispatch_errors"] == 0
        return r


def test_f1_failed_dispatch_then_full_reset(tmp_path):
    port = _f1("port", str(tmp_path / "port"))
    ref = _f1("jax", str(tmp_path / "jax"))
    assert port["n_points"] == ref["n_points"] > 100
    np.testing.assert_array_equal(port["host"]["cell"], ref["host"]["cell"])
    np.testing.assert_array_equal(port["host"]["count"],
                                  ref["host"]["count"])
    np.testing.assert_allclose(port["host"]["centroid"],
                               ref["host"]["centroid"], atol=1e-5)


def test_warm_leaves_grid_and_replay_unchanged(runs, tmp_path):
    r, _ = _replay("port", str(tmp_path / "w"), warm=True,
                   extra_fields=FIELDS)
    ref = runs["port"][0]
    for f in FIELDS:
        np.testing.assert_array_equal(r["host"][f], ref["host"][f])
    # a planar warm of a planar replay
    sweep = make_sweep(CFG, 4, 500, seed=6)
    out = []
    for warm in (False, True):
        with FusionSession(CFG, "cpu", output_dir=str(tmp_path),
                           batch_fill_wait=2.0) as s:
            if warm:
                s.warm()
                assert s.metrics()["occupied_voxels"] == 0
            s.start()
            for f in sweep:
                s.push_frame(make_cloud_frame(f.points_cam, f.rgb), f.pose)
            out.append(s.process()["host"])
    for f in FIELDS:
        np.testing.assert_array_equal(out[0][f], out[1][f])


def test_run_source_equals_push_loop(tmp_path):
    src = sources.SyntheticSource(CFG, 4, 500, seed=8)
    path = str(tmp_path / "sweep.npz")
    assert sources.save_sweep(path, src) == len(src) == 4
    out = []
    for how in ("loop", "run_source", "replay"):
        with FusionSession(CFG, "cpu", output_dir=str(tmp_path),
                           batch_fill_wait=2.0) as s:
            if how == "loop":
                s.start()
                for frame, pose in src:
                    s.push_frame(frame, pose)
                assert s.drain(600)
            elif how == "run_source":
                s.run_source(src)
            else:
                s.run_source(sources.load_sweep(path))
            assert s.metrics()["frames_integrated"] == 4
            out.append(s.process()["host"])
    assert out[0]["cell"].size > 100
    for r in out[1:]:
        for f in FIELDS:
            np.testing.assert_array_equal(r[f], out[0][f])


def test_sweep_files_cross_packages(tmp_path):
    src = sources.SyntheticSource(CFG, 3, 200, seed=9)
    p, j = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    sources.save_sweep(p, src)
    jsources.save_sweep(j, jsources.ReplaySource(
        *zip(*[(f, pose) for f, pose in jsources.SyntheticSource(
            JCFG, 3, 200, seed=9)])))
    for a, b in ((sources.load_sweep(j), jsources.load_sweep(p)),
                 (sources.load_sweep(p), jsources.load_sweep(j))):
        assert len(a) == len(b) == 3
        for (fa, pa), (fb, pb) in zip(a, b):
            assert fa.data == fb.data and fa.point_step == fb.point_step
            assert [(x.name, x.offset) for x in fa.fields] \
                == [(x.name, x.offset) for x in fb.fields]
            np.testing.assert_array_equal(pa, pb)
    dp, dj = str(tmp_path / "dp.npz"), str(tmp_path / "dj.npz")
    assert sources.save_depth_sweep(dp, FRAMES[:2], RAYS) == 2
    jsources.save_depth_sweep(dj, FRAMES[:2], RAYS)
    assert sources.is_depth_sweep(dj) and jsources.is_depth_sweep(dp)
    assert not sources.is_depth_sweep(p)
    (fa, ra), (fb, rb) = sources.load_depth_sweep(dj), \
        jsources.load_depth_sweep(dp)
    np.testing.assert_array_equal(ra, rb)
    for a, b in zip(fa, fb):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _batches():
    """The sweep's three K=2 batches as numpy arrays."""
    for i in range(0, 6, 2):
        fs = FRAMES[i:i + 2]
        yield (np.stack([f.depth_q for f in fs]),
               np.stack([f.rgb565 for f in fs]),
               np.full((2,), fs[0].count, np.int32),
               np.stack([f.pose for f in fs]))


def _jax_grid(config):
    """The JAX pipeline over the three batches with a refine after the
    second: numpy fields."""
    import jax.numpy as jnp
    pipe = JaxPipeline(config)
    g = pipe.init()
    rays = jnp.asarray(RAYS)
    for i, b in enumerate(_batches()):
        g = pipe.step_batch_depth(g, *map(jnp.asarray, b), rays)
        if i == 1:
            g = pipe.refine(g)
    return {f: np.asarray(getattr(g, f)) for f in g._fields}


def test_lane_budget_divergence_by_design():
    """Where the JAX package's batch lane budgets bind, it drops lanes and
    counts them; the port ignores the budgets, fuses every lane and holds
    the JAX package's grid with the budgets unbound."""
    bind = dict(batch_unique_lanes=1024, batch_hit_lanes=4)
    jbound = _jax_grid(dataclasses.replace(JCFG, **bind))
    jfree = _jax_grid(JCFG)
    pcfg = dataclasses.replace(CFG, **bind)
    pipe = FusionPipeline(pcfg, "cpu")
    g = pipe.init()
    rays = pipe.put(RAYS)
    for i, b in enumerate(_batches()):
        g = pipe.step_batch_depth(g, *map(pipe.put, b), rays)
        if i == 1:
            g = pipe.refine(g)
    port = convert.grid_to_numpy(g)
    # the JAX package drops lanes and counts them
    assert int(jbound["overflow_unique"]) > 0
    assert int(jbound["overflow_hits"]) > 0
    assert int(jfree["overflow_unique"]) == int(jfree["overflow_hits"]) == 0
    assert jbound["n_pts"].sum() < jfree["n_pts"].sum()
    # the port counts nothing and fuses every lane
    assert int(port["overflow_unique"]) == int(port["overflow_hits"]) == 0
    got, want = checks.by_cell(port, CFG), checks.by_cell(jfree, CFG)
    bound = checks.by_cell(jbound, CFG)
    assert bound["cell"].size < got["cell"].size
    for f in ("cell", "n_pts", "normal_found", "dep_count", "dep",
              "occ_bits", "buffer", "frames"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    ok, err = checks.cyl_stats_error(got["cyl_stats"], want["cyl_stats"],
                                     CFG.cylinder_radius)
    assert ok, err
