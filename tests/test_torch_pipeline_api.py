"""The pipelines' entry points beside ``step``: ``FusionPipeline.integrate``
(planar and depth wires), ``run_sweep``, ``extract_host(fields=)`` and
``extract_fetcher``, ``TsdfPipeline.extract_host(fields=)`` and
``extract_fetcher``, and the small functions ``geometry.project_to_axis``
and ``eigen33.smallest_eigenpair``, against the JAX package's (its
pipelines' jitted programs) on one ``small_test_config`` and inputs made
from seeds with numpy.

Extracts are compared by cell id: integer fields exactly; the float
fields within 1e-5 (``checks.RTOL`` and the normals' tolerance; the JAX
centroid comes back through ``centroid_from_wire``, within 1 ulp by its
own account); TSDF extracts under ``checks.TSDF_TOL``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.models import tsdf as jtsdf
from hifi_fusion_tpu.models.pipeline import FusionPipeline as JaxPipeline
from hifi_fusion_tpu.ops import eigen33 as jeigen
from hifi_fusion_tpu.ops import geometry as jgeometry
from hifi_fusion_tpu.ops.extract import to_host as jax_to_host
from hifi_fusion_tpu_torch import checks, convert
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.models import pipeline as pipeline_mod
from hifi_fusion_tpu_torch.models import tsdf
from hifi_fusion_tpu_torch.models.pipeline import FusionPipeline
from hifi_fusion_tpu_torch.ops import eigen33, geometry
from hifi_fusion_tpu_torch.ops.extract import EXTRACT_FIELDS
from hifi_fusion_tpu_torch.utils.synthetic import (camera_rays,
                                                   make_depth_sweep,
                                                   make_sweep, pad_frame)

KW = dict(refine_every=2, z_clip=(0.05, 10.0))
CFG = small_test_config(**KW)
JCFG = jax_config(**KW)
RAYS = camera_rays(64, 64, fx=80.0, fy=80.0)
DEPTH = make_depth_sweep(CFG, 4, width=64, height=64, srays=RAYS, seed=3,
                         noise_sd=3e-4, camera_height=0.4)
PLANAR = [pad_frame(f, CFG.max_points)
          for f in make_sweep(CFG, 4, 900, seed=4)]
INTS = ("cell", "count", "n_pts")
FLOATS = ("centroid", "normal", "sd", "mean_dist", "sd_dist", "rgb")
TOL = checks.RTOL
# the session's two export waves: the CSV's columns, then the PCD's
CSV_WAVE = ("sd", "mean_dist", "sd_dist", "count")
PCD_WAVE = ("cell", "centroid", "normal", "rgb")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _frame_args(i, f):
    """Frame ``i`` of the planar-then-depth sequence as the ``integrate``
    arguments of either package (numpy), ``rays`` for a depth frame."""
    if i < len(PLANAR):
        return (f.points_cam, f.rgb, f.mask, f.pose), None
    return (f.depth_q, f.rgb565, np.int32(f.count), f.pose), RAYS


def _same_extract(got: dict, want: dict, fields=INTS + FLOATS):
    np.testing.assert_array_equal(got["cell"], want["cell"])
    for f in fields:
        if f in INTS:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        else:
            np.testing.assert_allclose(got[f], want[f], atol=TOL,
                                       err_msg=f)


@pytest.fixture(scope="module")
def grids():
    """The port's and the JAX package's grids after four planar and four
    depth frames through ``integrate``, a refine after every second frame
    and a final one."""
    pipe, jpipe = FusionPipeline(CFG, "cpu"), JaxPipeline(JCFG)
    g, jg = pipe.init(), jpipe.init()
    for i, f in enumerate(PLANAR + DEPTH):
        args, rays = _frame_args(i, f)
        g = pipe.integrate(g, *map(_t, args),
                           rays=None if rays is None else _t(rays))
        jg = jpipe.integrate(jg, *map(jnp.asarray, args),
                             rays=None if rays is None else jnp.asarray(rays))
        if i % 2 == 1:
            g, jg = pipe.refine(g), jpipe.refine(jg)
    return pipe, pipe.refine(g), jpipe, jpipe.refine(jg)


def test_integrate_matches_jax(grids):
    pipe, g, jpipe, jg = grids
    got, want = pipe.extract_host(g), jax_to_host(jpipe.extract(jg))
    assert int(g.frames) == 8 and got["cell"].size > 500
    assert got["count"].sum() > 0
    _same_extract(got, want)
    assert {k: v for k, v in pipe.grid_metrics(g).items()
            if k.startswith("overflow") and v} == {}


def test_run_sweep_matches_jax_and_steps():
    pts, rgb, mask, poses = (np.stack([getattr(f, a) for f in PLANAR])
                             for a in ("points_cam", "rgb", "mask", "pose"))
    pipe, jpipe = FusionPipeline(CFG, "cpu"), JaxPipeline(JCFG)
    g = pipe.run_sweep(pipe.init(), *map(_t, (pts, rgb, mask, poses)))
    steps = pipe.init()
    for f in PLANAR:
        steps = pipe.step(steps, *map(_t, (f.points_cam, f.rgb, f.mask,
                                           f.pose)))
    assert checks.grid_problems(convert.grid_to_numpy(g),
                                convert.grid_to_numpy(steps), CFG) == []
    assert int(g.frames) == len(PLANAR) and int(g.normal_found.sum()) > 0
    jg = jpipe.run_sweep(jpipe.init(), *map(jnp.asarray,
                                            (pts, rgb, mask, poses)))
    _same_extract(pipe.extract_host(pipe.refine(g)),
                  jax_to_host(jpipe.extract(jpipe.refine(jg))))


def test_extract_fetcher_waves(grids, monkeypatch):
    """Two waves equal ``extract_host`` and the JAX fetcher's fields by
    cell; each field crosses to the host once."""
    pipe, g, jpipe, jg = grids
    fetched = []
    real = pipeline_mod.to_host

    def spy(result, fields=None, prefetch=()):
        fetched.extend(fields)
        return real(result, fields, prefetch)

    monkeypatch.setattr(pipeline_mod, "to_host", spy)
    fetch = pipe.extract_fetcher(g)
    first = fetch(CSV_WAVE)
    second = fetch(PCD_WAVE, prefetch=("n_pts",))
    every = fetch()
    monkeypatch.undo()
    assert list(first) == list(CSV_WAVE) and list(second) == list(PCD_WAVE)
    assert sorted(fetched) == sorted(EXTRACT_FIELDS)
    whole = pipe.extract_host(g)
    assert list(every) == list(whole) == list(EXTRACT_FIELDS)
    for f in EXTRACT_FIELDS:
        assert every[f].tobytes() == whole[f].tobytes(), f
        wave = first if f in CSV_WAVE else second
        if f in wave:
            assert wave[f].tobytes() == whole[f].tobytes(), f
    assert set(pipe.extract_host(g, fields=("normal", "count"))) == {
        "normal", "count"}
    jfetch = jpipe.extract_fetcher(jg)
    want = {**jfetch(("normal", "var_t", "mean_dist", "sd_dist", "count")),
            **jfetch(("centroid", "rgb_packed")),
            **jfetch(("cell", "sd", "rgb", "n_pts"))}
    _same_extract(every, want)


def test_extract_cap_returns_the_whole_cloud(grids):
    """``extract_cap`` is ignored: a cap of 8 still returns every voxel,
    as the JAX package's uncapped retry does."""
    pipe, g, _, _ = grids
    capped = FusionPipeline(dataclasses.replace(CFG, extract_cap=8), "cpu")
    host = capped.extract_host(g)
    assert host["cell"].size > 8
    whole = pipe.extract_host(g)
    fetched = capped.extract_fetcher(g)()
    for f in EXTRACT_FIELDS:
        assert host[f].tobytes() == whole[f].tobytes() \
            == fetched[f].tobytes(), f


def test_tsdf_extract_fetcher_matches_jax():
    params = dict(truncation=0.011, n_samples=5, min_weight=2.0)
    tp = tsdf.TsdfPipeline(tsdf.TsdfConfig(base=CFG, **params), "cpu")
    jtp = jtsdf.TsdfPipeline(jtsdf.TsdfConfig(base=JCFG, **params))
    depth = [np.stack([getattr(f, a) for f in DEPTH])
             for a in ("depth_q", "rgb565")]
    counts = np.asarray([f.count for f in DEPTH], np.int32)
    poses = np.stack([f.pose for f in DEPTH])
    g = tp.step_batch_depth(tp.init(), *map(_t, (*depth, counts, poses,
                                                 RAYS)))
    jg = jtp.step_batch_depth(jtp.init(), *map(jnp.asarray,
                                               (*depth, counts, poses,
                                                RAYS)))
    want = jtp.extract_fetcher(jg)()
    fetch = tp.extract_fetcher(g)
    csv = fetch(("sd", "mean_dist", "sd_dist", "count"))
    got = {**csv, **fetch(("cell", "centroid", "normal", "rgb",
                           "rgb_packed", "n_pts", "var_t"))}
    assert set(fetch()) == set(want) and got["cell"].size > 200
    for f in ("cell", "count", "n_pts", "rgb_packed", "sd", "sd_dist",
              "var_t", "rgb"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f, tol in (("mean_dist", checks.TSDF_TOL["tsdf"]),
                   ("centroid", checks.TSDF_TOL["centroid"]),
                   ("normal", checks.TSDF_TOL["normal"])):
        np.testing.assert_allclose(got[f], want[f], atol=tol, err_msg=f)
    sub = tp.extract_host(g, fields=("cell", "count"))
    assert list(sub) == ["cell", "count"]
    np.testing.assert_array_equal(sub["count"], want["count"])
    whole = tp.extract_host(g)
    assert set(whole) == set(jtp.extract_host(jg))
    for f in whole:
        assert whole[f].tobytes() == fetch()[f].tobytes(), f


def test_project_to_axis_matches_jax():
    rng = np.random.default_rng(7)
    q = rng.normal(scale=0.01, size=(3, 512)).astype(np.float32)
    n = rng.normal(size=(3, 512))
    n = (n / np.linalg.norm(n, axis=0)).astype(np.float32)
    proj, dist = geometry.project_to_axis(_t(q), _t(n))
    jproj, jdist = jgeometry.project_to_axis(jnp.asarray(q), jnp.asarray(n))
    assert proj.shape == (3, 512) and dist.shape == (512,)
    # f32 rounding of the three-term sums: a few ulps of 0.01
    np.testing.assert_allclose(proj.numpy(), np.asarray(jproj), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=0,
                               atol=1e-8)


def test_smallest_eigenpair_matches_jax():
    rng = np.random.default_rng(8)
    m = rng.normal(size=(256, 3, 3))
    cov = (m @ m.transpose(0, 2, 1)).astype(np.float32)
    val, vec = eigen33.smallest_eigenpair(_t(cov))
    jval, jvec = map(np.asarray, jeigen.smallest_eigenpair(jnp.asarray(cov)))
    assert val.shape == (256,) and vec.shape == (256, 3)
    scale = np.abs(cov).max(axis=(1, 2))
    np.testing.assert_allclose(val.numpy() / scale, jval / scale, rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(np.abs(np.sum(vec.numpy() * jvec, axis=1)),
                               1.0, atol=TOL)
