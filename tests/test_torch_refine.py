"""The port's refine pass against the JAX package's, from one carried state.

The state (one batch, a refine, a second batch, taken from the JAX
package and carried across by ``convert.py``) has candidates, existing
dependants and a buffer to replay.  Both packages refine it, with
``reclaim_buffer`` on and off and with ``line_k=1``; compared by cell
id:

* the cell set (ghost line cells included), the normal_found set, each
  cell's dependant owners, dep_count, the buffer contents, buf_count and
  reclaimed: exact;
* normals: within 1e-5 (moment sums and acos/cos may round differently);
* cylinder statistics: hits exact, sums within ``checks.cyl_stats_error``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from hifi_fusion_tpu import grid as jgrid
from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.models import pipeline as jpipe
from hifi_fusion_tpu.ops.refine import refine_pass as jax_refine
from hifi_fusion_tpu_torch import checks, convert
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.grid import quick_counts
from hifi_fusion_tpu_torch.ops.refine import refine_pass
from hifi_fusion_tpu_torch.utils.synthetic import camera_rays, make_depth_sweep

KW = dict(refine_every=4, max_batch_frames=4, z_clip=(0.05, 10.0))
CFG = small_test_config(**KW)
JCFG = jax_config(**KW)
W, H = 64, 64
RAYS = camera_rays(W, H, fx=80.0, fy=80.0)
FRAMES = make_depth_sweep(CFG, 8, width=W, height=H, srays=RAYS, seed=5,
                          noise_sd=3e-4, camera_height=0.4)


def _batch(i, k=4):
    fs = FRAMES[k * i:k * i + k]
    return tuple(jnp.asarray(a) for a in (
        np.stack([f.depth_q for f in fs]), np.stack([f.rgb565 for f in fs]),
        np.full((k,), W * H, np.int32), np.stack([f.pose for f in fs])))


@pytest.fixture(scope="module")
def state():
    g = jgrid.make_grid(JCFG)
    jr = jnp.asarray(RAYS)
    g = jpipe.integrate_batch_depth(g, *_batch(0), jr, config=JCFG)
    g = jax_refine(g, config=JCFG)
    g = jpipe.integrate_batch_depth(g, *_batch(1), jr, config=JCFG)
    return g


@pytest.mark.parametrize("reclaim", [True, False])
def test_refine_vs_jax_from_carried_state(state, reclaim):
    _refine_vs_jax(state, reclaim_buffer=reclaim)


def test_refine_vs_jax_line_k1(state):
    """Lines of three steps: fewer than a replay group's four lanes."""
    _refine_vs_jax(state, line_k=1)


def _refine_vs_jax(state, **change):
    cfg = dataclasses.replace(CFG, **change)
    jcfg = dataclasses.replace(JCFG, **change)
    reclaim = cfg.reclaim_buffer
    start = {f: np.asarray(getattr(state, f)) for f in state._fields}
    g = convert.grid_from_jax(start, cfg, "cpu")
    n_cand = int(((g.n_pts > 0) & ~g.normal_found).sum())
    assert n_cand > 0 and int(g.dep_count.max()) > 0 \
        and int(g.buf_count) > 0
    refine_pass(g, cfg)
    jg = jax_refine(jgrid.GridState(*[jnp.asarray(start[f])
                                      for f in state._fields]),
                    config=jcfg)
    got = checks.by_cell(convert.grid_to_numpy(g), cfg)
    want = checks.by_cell({f: np.asarray(getattr(jg, f))
                           for f in jg._fields}, cfg)

    np.testing.assert_array_equal(got["cell"], want["cell"])
    assert got["cell"].size > checks.by_cell(start, cfg)["cell"].size, \
        "the pass created ghost line cells"
    for f in ("normal_found", "dep_count", "dep", "buffer", "n_pts",
              "occ_bits"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("buf_count", "reclaimed", "overflow_probe", "overflow_dep",
              "overflow_refine"):
        assert got[f] == want[f], f
    assert got["overflow_dep"] == 0 and got["overflow_refine"] == 0
    if reclaim:
        assert got["reclaimed"] > int(start["reclaimed"])
    else:
        assert got["buf_count"] == int(start["buf_count"])
    np.testing.assert_allclose(got["normal"], want["normal"], atol=1e-5)
    ok, err = checks.cyl_stats_error(got["cyl_stats"], want["cyl_stats"],
                                     cfg.cylinder_radius)
    assert ok, err
    assert quick_counts(g, cfg) == jgrid.quick_counts(jg, jcfg)
    replayed = (want["cyl_stats"][:, 4].sum()
                - checks.by_cell(start, cfg)["cyl_stats"][:, 4].sum())
    assert replayed > 0, "the pass replayed buffered points"


def test_refine_on_empty_grid_is_a_no_op():
    from hifi_fusion_tpu_torch.grid import make_grid
    g = make_grid(CFG, "cpu")
    before = convert.grid_to_numpy(g)
    refine_pass(g, CFG)
    after = convert.grid_to_numpy(g)
    for f in before:
        np.testing.assert_array_equal(before[f], after[f], err_msg=f)
