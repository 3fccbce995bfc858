"""The fusion step's budgets and edge cases, and the refine's line cells,
against the JAX package under ``jit``.

The port's plain path (the plain versions of kernels B3, B6 and B7 and of
K2, on CPU tensors) and the JAX package start from one seeded state,
carried across by ``convert.py``, take the same step and are compared by
cell id (``checks.by_cell``): the cell set, every integer field and
counter, the buffer and the dependant lists exactly, the integer-valued
rgb sums exactly, normals within 1e-5 and the cylinder statistics under
``checks.cyl_stats_error`` (hits exactly, sums rtol 1e-5).

One config: ``max_active_points=1536``, so that a K=4 batch of 64x64 depth
frames (16,384 lanes, all valid) keeps NA = 6,144 of them, and
``max_dependants=2``, so that the dependant cap binds.  The state: a depth
batch of the seeded sweep, then a batch of planar frames of a plane whose
normal is (1, 1, 1)/sqrt(3), so that a line of cell-pitch steps along it
visits one cell twice.  The cases:

* integrate: the active-lane budget binding on the depth wire; the same
  on the planar wire with a router's ``extra_dropped``; a buffer append
  that does not fit (all or nothing, ``overflow_buf``); K=1; an empty
  batch;
* refine, with and without reclamation: the dependant cap binding
  (``overflow_dep``, and which owners win) and lines that revisit a cell.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifi_fusion_tpu import grid as jgrid
from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.models import pipeline as jpipe
from hifi_fusion_tpu.ops import integrate as jint
from hifi_fusion_tpu.ops.refine import refine_pass as jax_refine
from hifi_fusion_tpu_torch import checks, convert
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.models.pipeline import FusionPipeline
from hifi_fusion_tpu_torch.ops import refine
from hifi_fusion_tpu_torch.utils.synthetic import camera_rays, make_depth_sweep

KW = dict(refine_every=4, max_batch_frames=4, z_clip=(0.05, 10.0),
          max_active_points=1536, max_dependants=2)
CFG = small_test_config(**KW)
JCFG = jax_config(**KW)
W = H = 64
N = W * H
RAYS = camera_rays(W, H, fx=80.0, fy=80.0)
FRAMES = make_depth_sweep(CFG, 12, width=W, height=H, srays=RAYS, seed=11,
                          noise_sd=3e-4, camera_height=0.4)


def _depth(i, k=4, count=N):
    fs = FRAMES[4 * i:4 * i + k]
    return (np.stack([f.depth_q for f in fs]),
            np.stack([f.rgb565 for f in fs]),
            np.full((k,), count, np.int32), np.stack([f.pose for f in fs]))


def _plane(seed, k=4):
    """K planar frames of points on x + y + z = 0.18 (camera = world),
    lanes masked to 0.06 < z < 0.30, f32 integer colour."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.12, 0.12, (k, 2, N))
    z = 0.18 - xy[:, 0] - xy[:, 1] + rng.normal(0.0, 2e-4, (k, N))
    pts = np.concatenate([xy, z[:, None]], axis=1).astype(np.float32)
    rgb = rng.integers(0, 256, (k, 3, N)).astype(np.float32)
    poses = np.broadcast_to(np.eye(4, dtype=np.float32), (k, 4, 4)).copy()
    return pts, rgb, (z > 0.06) & (z < 0.30), poses


def _fields(g):
    return {f: np.asarray(getattr(g, f)) for f in g._fields}


def _jax_grid(fields):
    return jgrid.GridState(*[jnp.asarray(fields[f])
                             for f in jgrid.GridState._fields])


@pytest.fixture(scope="module")
def states():
    """JAX states: ``carried`` after the depth batch and the plane batch
    (no refine yet), and ``refined`` after a refine of it."""
    jr = jnp.asarray(RAYS)
    g = jgrid.make_grid(JCFG)
    g = jpipe.integrate_batch_depth(g, *map(jnp.asarray, _depth(0)), jr,
                                    config=JCFG)
    g = jpipe.integrate_batch(g, *map(jnp.asarray, _plane(1)), config=JCFG)
    carried = _fields(g)
    refined = _fields(jax_refine(_jax_grid(carried), config=JCFG))
    return carried, refined


def _compare(port_grid, jax_fields, cfg):
    got = checks.by_cell(convert.grid_to_numpy(port_grid), cfg)
    want = checks.by_cell(jax_fields, cfg)
    np.testing.assert_array_equal(got["cell"], want["cell"])
    for f in ("n_pts", "normal_found", "dep_count", "dep", "viewpoint",
              "occ_bits", "buffer", "rgb_sum"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("buf_count", "overflow_probe", "overflow_buf", "overflow_dep",
              "overflow_refine", "overflow_active", "reclaimed", "frames"):
        assert got[f] == want[f], f
    np.testing.assert_allclose(got["normal"], want["normal"], atol=1e-5)
    ok, err = checks.cyl_stats_error(got["cyl_stats"], want["cyl_stats"],
                                     cfg.cylinder_radius)
    assert ok, err
    return got


@partial(jax.jit, static_argnames=("config",))
def _jax_planar_dropped(g, pts, rgb, mask, poses, dropped, *, config):
    """The JAX package's batched planar integrate with a router's drops
    (``extra_dropped``, integrate.py:322-325), at the batch budgets."""
    return jint.integrate_frame_impl(
        g, pts, rgb, mask, poses, config=config, extra_dropped=dropped,
        dep_width_tiers=config.dep_width_tiers,
        **jpipe.batch_lane_budgets(config, poses.shape[0]))


INTEGRATE_CASES = ("active_budget", "planar_dropped", "buffer_full", "k1",
                   "empty")


@pytest.mark.parametrize("case", INTEGRATE_CASES)
def test_integrate_step_vs_jax(states, case):
    """One step from the refined state, both packages; then by cell id."""
    start = dict(states[1])
    NA = 4 * CFG.max_active_points
    if case == "buffer_full":
        # the batch cannot fit: buf_count + NA > B, so nothing is appended
        start["buf_count"] = np.asarray(CFG.buffer_capacity - NA + 1,
                                        np.int32)
    g = convert.grid_from_jax(start, CFG, "cpu")
    pipe = FusionPipeline(CFG, "cpu")
    rays = torch.from_numpy(RAYS)
    jg, jr = _jax_grid(start), jnp.asarray(RAYS)
    if case == "planar_dropped":
        p = _plane(2)
        pipe.step_batch(g, *map(torch.from_numpy, p), extra_dropped=5)
        jg = _jax_planar_dropped(jg, *map(jnp.asarray, p), jnp.int32(5),
                                 config=JCFG)
    elif case == "k1":
        d, c, n, t = _depth(1, k=1)
        pipe.step_depth(g, *(torch.from_numpy(a[0]) for a in (d, c)),
                        torch.tensor(N, dtype=torch.int32),
                        torch.from_numpy(t[0]), rays)
        jg = jpipe.fusion_step_depth(jg, jnp.asarray(d[0]),
                                     jnp.asarray(c[0]), jnp.int32(N),
                                     jnp.asarray(t[0]), jr, config=JCFG)
    else:
        b = _depth(1, count=0 if case == "empty" else N)
        pipe.step_batch_depth(g, *map(torch.from_numpy, b), rays)
        jg = jpipe.integrate_batch_depth(jg, *map(jnp.asarray, b), jr,
                                         config=JCFG)
    before = checks.by_cell(start, CFG)
    got = _compare(g, _fields(jg), CFG)
    added = got["overflow_active"] - before["overflow_active"]
    k = 1 if case == "k1" else 4
    assert got["frames"] == before["frames"] + k
    if case == "empty":
        assert got["cell"].size == before["cell"].size and added == 0
        assert got["buf_count"] == before["buf_count"]
    elif case == "active_budget" or case == "buffer_full":
        assert added == 4 * N - NA
    elif case == "planar_dropped":
        n_valid = int(_plane(2)[2].sum())
        assert added == n_valid - NA + 5 and n_valid > NA
    if case == "buffer_full":
        assert got["overflow_buf"] > before["overflow_buf"]
        assert got["buf_count"] == before["buf_count"]
    elif case != "empty":
        assert got["buf_count"] > before["buf_count"]
        assert got["overflow_buf"] == before["overflow_buf"]


def _revisits(fields, cfg) -> int:
    """Cells whose dependant list holds one owner twice (a line that
    revisits the cell)."""
    dep = checks.by_cell(fields, cfg)["dep"]
    live = dep != np.iinfo(np.int32).max
    return int(sum(np.unique(r[m]).size < m.sum()
                   for r, m in zip(dep, live)))


@pytest.mark.parametrize("reclaim", [True, False])
def test_refine_lines_vs_jax(states, reclaim):
    """The refine of the carried state: D binds (``overflow_dep`` grows,
    and the same owners win in every cell) and the plane's lines revisit
    cells; then by cell id."""
    cfg = dataclasses.replace(CFG, reclaim_buffer=reclaim)
    jcfg = dataclasses.replace(JCFG, reclaim_buffer=reclaim)
    carried = states[0]
    g = convert.grid_from_jax(carried, cfg, "cpu")
    refine.refine_pass(g, cfg)
    want = states[1] if reclaim else _fields(
        jax_refine(_jax_grid(carried), config=jcfg))
    got = _compare(g, want, cfg)
    before = checks.by_cell(carried, cfg)
    assert got["overflow_dep"] > before["overflow_dep"]
    assert got["normal_found"].sum() > before["normal_found"].sum()
    assert _revisits(convert.grid_to_numpy(g), cfg) > 0
    if not reclaim:
        assert got["buf_count"] == before["buf_count"]
