"""Checkpoints across the two packages: ``save_state`` / ``load_state`` in
the JAX package's npz layout, for the fusion and the TSDF families.

One seeded 8-frame 64x64 depth sweep (``small_test_config(refine_every=4,
max_batch_frames=4, z_clip=(0.05, 10.0))``, K=4 batches) runs through a
JAX session and a port session; each saves its grid, and each package
loads the other's checkpoint and runs ``process()``:

* the npz files have the same fields, shapes and dtypes (the port pads the
  JAX scratch tails back);
* a checkpoint loaded into the other package holds the same grid, by
  cell id (the packages' hashes may place a cell in other slots): every
  integer field and counter exactly, and the f32 fields too, since a load
  copies them;
* the two packages' own grids agree as the slice tests hold them: the
  integer fields exactly, normals within 1e-5, rgb sums within rtol 1e-6,
  cylinder sums under ``checks.cyl_stats_error``; the TSDF grids exactly
  (``checks.tsdf_grid_problems``);
* ``process()`` of a loaded checkpoint exports the cells, counts and
  centroids (within 1e-5 m) that the saving session's own ``process()``
  exports.
"""

import numpy as np
import pytest

from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.runtime.session import FusionSession as JaxSession
from hifi_fusion_tpu_torch import checks
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.runtime.session import FusionSession
from hifi_fusion_tpu_torch.utils.synthetic import camera_rays, make_depth_sweep

KW = dict(refine_every=4, max_batch_frames=4, z_clip=(0.05, 10.0))
CFG = small_test_config(**KW)
JCFG = jax_config(**KW)
TSDF = dict(truncation=0.011, n_samples=5, min_weight=2.0)
RAYS = camera_rays(64, 64, fx=80.0, fy=80.0)
FRAMES = make_depth_sweep(CFG, 8, width=64, height=64, srays=RAYS, seed=3,
                          noise_sd=3e-4, camera_height=0.4)
FIELDS = ("cell", "count", "centroid", "normal", "mean_dist")
FAMILIES = ("fusion", "tsdf")


def _session(pkg, model, out):
    kw = dict(output_dir=out, batch_fill_wait=2.0, model=model,
              model_params=TSDF if model == "tsdf" else None)
    if pkg == "port":
        return FusionSession(CFG, "cpu", **kw)
    return JaxSession(JCFG, **kw)


def _replay_save(pkg, model, tmp):
    """Replay the sweep, save the grid, then process(): (npz path,
    process result)."""
    path = str(tmp / f"{pkg}_{model}.npz")
    with _session(pkg, model, str(tmp / f"{pkg}_{model}")) as s:
        s.start()
        for f in FRAMES:
            assert s.push_depth_frame(f.depth_q, f.rgb565, f.pose,
                                      rays=RAYS)
        assert s.drain(600)
        s.save_state(path)
        return path, s.process(extra_fields=FIELDS)


def _load_process(pkg, model, path, tmp):
    with _session(pkg, model, str(tmp / f"{pkg}_{model}_loaded")) as s:
        s.load_state(path)
        return s.process(extra_fields=FIELDS)


@pytest.fixture(scope="module", params=FAMILIES)
def runs(request, tmp_path_factory):
    model = request.param
    tmp = tmp_path_factory.mktemp(model)
    saved = {pkg: _replay_save(pkg, model, tmp) for pkg in ("port", "jax")}
    # each package loads the other's checkpoint
    loaded = {"port": _load_process("port", model, saved["jax"][0], tmp),
              "jax": _load_process("jax", model, saved["port"][0], tmp)}
    return model, saved, loaded


def _npz(path):
    with np.load(path) as z:
        return {f: z[f] for f in z.files}


def test_npz_layouts_match(runs):
    _, saved, _ = runs
    a, b = _npz(saved["port"][0]), _npz(saved["jax"][0])
    assert set(a) == set(b)
    for f in a:
        assert a[f].shape == b[f].shape and a[f].dtype == b[f].dtype, f


def _by_cell(model, fields):
    if model == "tsdf":
        return checks.tsdf_by_cell(fields, CFG.capacity)
    return checks.by_cell(fields, CFG)


def test_loaded_state_is_the_saved_grid(runs, tmp_path):
    """A checkpoint written by one package and loaded by the other's
    session saves back to the same grid, by cell id."""
    model, saved, _ = runs
    for src in ("port", "jax"):
        want = _by_cell(model, _npz(saved[src][0]))
        pkg = "jax" if src == "port" else "port"
        out = tmp_path / f"{pkg}_again.npz"
        with _session(pkg, model, str(tmp_path)) as s:
            s.load_state(saved[src][0])
            s.save_state(str(out))
        got = _by_cell(model, _npz(out))
        assert set(got) == set(want)
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        assert want["cell"].size > 300


def test_saved_grids_agree_by_cell(runs):
    model, saved, _ = runs
    a = _npz(saved["port"][0])
    b = _npz(saved["jax"][0])
    if model == "tsdf":
        assert checks.tsdf_grid_problems(a, b, CFG.capacity) == []
        return
    ga, gb = checks.by_cell(a, CFG), checks.by_cell(b, CFG)
    for f in ("cell", "n_pts", "normal_found", "dep_count", "dep",
              "viewpoint", "occ_bits", "buffer", "buf_count",
              "overflow_probe", "overflow_buf", "overflow_dep",
              "overflow_refine", "overflow_active", "reclaimed", "frames"):
        np.testing.assert_array_equal(ga[f], gb[f], err_msg=f)
    np.testing.assert_allclose(ga["normal"], gb["normal"], atol=1e-5)
    np.testing.assert_allclose(ga["rgb_sum"], gb["rgb_sum"], rtol=1e-6)
    ok, err = checks.cyl_stats_error(ga["cyl_stats"], gb["cyl_stats"],
                                     CFG.cylinder_radius)
    assert ok, err
    assert ga["frames"] == len(FRAMES)


@pytest.mark.parametrize("loader", ["port", "jax"])
def test_loaded_state_processes_like_the_saver(runs, loader):
    model, saved, loaded = runs
    saver = "jax" if loader == "port" else "port"
    got, want = loaded[loader]["host"], saved[saver][1]["host"]
    assert loaded[loader]["n_points"] == saved[saver][1]["n_points"] > 100
    np.testing.assert_array_equal(got["cell"], want["cell"])
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_allclose(got["centroid"], want["centroid"],
                               atol=1e-5)
    np.testing.assert_allclose(got["normal"], want["normal"], atol=1e-5)
    np.testing.assert_allclose(got["mean_dist"], want["mean_dist"],
                               atol=1e-5)
