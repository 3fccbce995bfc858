"""The port's depth integration against the JAX package's.

Both packages get the same numpy inputs (one seeded depth sweep).  The
frontend is compared bit for bit; ``integrate_batch_depth`` starts both
packages from one JAX state carried across by ``convert.py`` (taken after
one JAX refine, so dependants exist) and is compared by cell id:

* n_pts, viewpoint, occupancy bits, dependants, buffer contents: exact;
* rgb_sum: rtol 1e-6 (integer-valued sums, so in fact exact);
* cylinder statistics: hits exact, sums rtol 1e-5 (addition order;
  ``checks.cyl_stats_error`` states the bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifi_fusion_tpu import grid as jgrid
from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.models import pipeline as jpipe
from hifi_fusion_tpu.ops import geometry as jgeo
from hifi_fusion_tpu.ops import integrate as jint
from hifi_fusion_tpu.ops.refine import refine_pass as jax_refine
from hifi_fusion_tpu_torch import checks, convert
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.grid import make_grid
from hifi_fusion_tpu_torch.ops import integrate
from hifi_fusion_tpu_torch.utils.synthetic import camera_rays, make_depth_sweep

KW = dict(refine_every=4, max_batch_frames=4, z_clip=(0.05, 10.0))
CFG = small_test_config(**KW)
JCFG = jax_config(**KW)
W, H = 64, 64
RAYS = camera_rays(W, H, fx=80.0, fy=80.0)
FRAMES = make_depth_sweep(CFG, 8, width=W, height=H, srays=RAYS, seed=3,
                          noise_sd=3e-4, camera_height=0.4)


def _batch(i, k=4):
    fs = FRAMES[k * i:k * i + k]
    return (np.stack([f.depth_q for f in fs]),
            np.stack([f.rgb565 for f in fs]),
            np.full((k,), W * H, np.int32),
            np.stack([f.pose for f in fs]))


def _jax_fields(g):
    return {f: np.asarray(getattr(g, f)) for f in g._fields}


@pytest.fixture(scope="module")
def carried():
    """JAX state after one batch + one refine, and the JAX result of the
    second batch on it."""
    g = jgrid.make_grid(JCFG)
    jr = jnp.asarray(RAYS)
    g = jpipe.integrate_batch_depth(g, *map(jnp.asarray, _batch(0)), jr,
                                    config=JCFG)
    g = jax_refine(g, config=JCFG)
    before = _jax_fields(g)
    g = jpipe.integrate_batch_depth(g, *map(jnp.asarray, _batch(1)), jr,
                                    config=JCFG)
    return before, _jax_fields(g)


def test_frontend_bit_exact_vs_jax():
    depth, rgb, counts, poses = _batch(1)
    counts = counts.copy()
    counts[2] = 1000                      # a count prefix shorter than N
    # the JAX package's batched depth frontend (integrate.py:110-175,
    # 241-287), composed from its own functions
    pc, jrgb, mask = jint._unpack_inputs(
        jnp.asarray(depth), jnp.asarray(rgb), jnp.asarray(counts), None,
        rays=jnp.asarray(RAYS))
    wpl = jax.vmap(jgeo.transform_points)(pc, jnp.asarray(poses)) \
        .transpose(1, 0, 2)
    coords = jgeo.cell_coords(wpl, JCFG)
    zmin, zmax = JCFG.z_clip
    valid = (mask & (pc[:, 2] > zmin) & (pc[:, 2] < zmax)
             & jgeo.valid_points(wpl, JCFG) & jgeo.valid_coords(coords, JCFG))
    jids = np.asarray(jgeo.cell_id(coords, JCFG)).reshape(-1)
    jvalid = np.asarray(valid).reshape(-1)

    t = [torch.from_numpy(a) for a in (depth, rgb, counts, poses)]
    world, ids, trgb = integrate.depth_frontend(*t, torch.from_numpy(RAYS),
                                                CFG)
    ids = ids.numpy()
    assert 0 < jvalid.sum() < jvalid.size
    np.testing.assert_array_equal(ids != np.iinfo(np.int32).max, jvalid)
    np.testing.assert_array_equal(ids[jvalid], jids[jvalid])
    np.testing.assert_array_equal(world.numpy(),
                                  np.asarray(wpl).reshape(3, -1))
    np.testing.assert_array_equal(
        trgb.numpy(), np.asarray(jrgb).transpose(1, 0, 2).reshape(3, -1))


def test_integrate_batch_vs_jax_from_carried_state(carried):
    before, want_fields = carried
    g = convert.grid_from_jax(before, CFG, "cpu")
    assert int(g.dep_count.max()) > 0, "the carried state has dependants"
    t = [torch.from_numpy(a) for a in _batch(1)]
    integrate.integrate_batch_depth(g, *t, torch.from_numpy(RAYS), CFG)
    got = checks.by_cell(convert.grid_to_numpy(g), CFG)
    want = checks.by_cell(want_fields, CFG)

    np.testing.assert_array_equal(got["cell"], want["cell"])
    for f in ("n_pts", "normal_found", "dep_count", "dep", "viewpoint",
              "occ_bits", "buffer", "normal"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    for f in ("buf_count", "overflow_probe", "overflow_buf", "overflow_dep",
              "overflow_active", "frames"):
        assert got[f] == want[f], f
    np.testing.assert_allclose(got["rgb_sum"], want["rgb_sum"], rtol=1e-6)
    ok, err = checks.cyl_stats_error(got["cyl_stats"], want["cyl_stats"],
                                     CFG.cylinder_radius)
    assert ok, err
    new_hits = want["cyl_stats"][:, 4].sum() - checks.by_cell(
        before, CFG)["cyl_stats"][:, 4].sum()
    assert new_hits > 0, "the batch streamed points through dependants"


def test_batch_equals_sequential_frames(carried):
    """A K-batch is sequentially equivalent: integrating the 4 frames one
    at a time (integrate_depth) gives the same grid by cell id, integer
    fields exact and f32 sums up to addition order."""
    before, _ = carried
    rays = torch.from_numpy(RAYS)
    depth, rgb, counts, poses = (torch.from_numpy(a) for a in _batch(1))
    a = convert.grid_from_jax(before, CFG, "cpu")
    b = convert.grid_from_jax(before, CFG, "cpu")
    integrate.integrate_batch_depth(a, depth, rgb, counts, poses, rays, CFG)
    for i in range(4):
        integrate.integrate_depth(b, depth[i], rgb[i], counts[i], poses[i],
                                  rays, CFG)
    ga = checks.by_cell(convert.grid_to_numpy(a), CFG)
    gb = checks.by_cell(convert.grid_to_numpy(b), CFG)
    for f in ("cell", "n_pts", "viewpoint", "occ_bits", "buffer", "dep",
              "rgb_sum"):
        np.testing.assert_array_equal(ga[f], gb[f], err_msg=f)
    assert ga["frames"] == gb["frames"] == 8
    ok, err = checks.cyl_stats_error(ga["cyl_stats"], gb["cyl_stats"],
                                     CFG.cylinder_radius)
    assert ok, err


def test_wrappers_route_by_device():
    """A CPU tensor runs the plain version and launches nothing; a tensor
    on any other non-CUDA device raises instead of falling back."""
    from hifi_fusion_tpu_torch import kernels
    from hifi_fusion_tpu_torch.ops import hashing, refine
    before = dict(kernels.LAUNCHES)
    g = make_grid(CFG, "cpu")
    t = [torch.from_numpy(a) for a in _batch(0)]
    integrate.integrate_batch_depth(g, *t, torch.from_numpy(RAYS), CFG)
    refine.refine_pass(g, CFG)
    assert int(g.normal_found.sum()) > 0
    assert kernels.LAUNCHES == before
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        hashing.lookup_or_insert(torch.full((16,), -1, dtype=torch.int32,
                                            device="meta"), meta, 4, 16)
    with pytest.raises(ValueError):
        integrate.depth_frontend(*[x.to("meta") for x in t],
                                 torch.from_numpy(RAYS).to("meta"), CFG)
