"""Slab sharding (hifi_fusion_tpu_torch/parallel/sharding.py) against the
JAX package's ``ShardedFusion`` on the conftest's virtual CPU devices, at
``small_test_config`` with n in {2, 4} shards, replicated and routed.

One seeded 9-frame 64x64 depth sweep goes through both: two K=4 depth
batches with a refine after each, then one frame alone, a final refine
and the extract.  The lone frame is a depth frame (``step_depth``, with
its fused refine check) at n2-replicated and n4-routed, and a planar one
(``integrate``) at n2-routed and n4-replicated, so that each wire's single
step runs replicated and routed; each distinct JAX program costs seconds
of CPU compile.  The extracts must
hold the same global cell ids with the same cylinder and point counts
(centroids, normals and spreads within 1e-5), ``metrics()`` must be equal,
and every shard's grid must equal the JAX shard's by cell id: integer
fields, occupancy bits, dependants and counters exactly, normals within
1e-5, colour sums within rtol 1e-6 and cylinder sums within
``checks.cyl_stats_error`` (addition order).  That holds the shard offset
through the frontend, the dependant stream, the refine's line cells and
the extract's core slab.

Also: a routed budget that drops (``route_betas=(0.05,)``; JAX's
``route_beta=0.05``, as tests/test_routing.py:209) drops and counts what
JAX drops, its extract fetched whole and by field alike, and the
launch-file extent's arithmetic (as tests/test_sharding.py:72-92).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifi_fusion_tpu.config import FusionConfig as JaxConfig
from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.parallel.sharding import ShardedFusion as JaxSharded
from hifi_fusion_tpu_torch import checks, convert
from hifi_fusion_tpu_torch.config import FusionConfig, small_test_config
from hifi_fusion_tpu_torch.models.pipeline import refine_due
from hifi_fusion_tpu_torch.parallel.sharding import (ShardedFusion,
                                                     shard_devices)
from hifi_fusion_tpu_torch.utils.synthetic import camera_rays, make_depth_sweep

KW = dict(refine_every=4, max_batch_frames=4, z_clip=(0.05, 10.0))
CFG = small_test_config(**KW)
JCFG = jax_config(**KW)
RAYS = camera_rays(64, 64, fx=80.0, fy=80.0)
FRAMES = make_depth_sweep(CFG, 9, width=64, height=64, srays=RAYS, seed=0,
                          noise_sd=3e-4, camera_height=0.4)
K = 4
CASES = ["n2-replicated", "n2-routed", "n4-replicated", "n4-routed"]
SCALARS = ("buf_count", "overflow_probe", "overflow_buf", "overflow_dep",
           "overflow_refine", "overflow_active", "reclaimed", "frames")


def _rgb(f):
    v = f.rgb565.astype(np.int64)
    return np.stack([((v >> 11) & 0x1F) * 8, ((v >> 5) & 0x3F) * 4,
                     (v & 0x1F) * 8]).astype(np.float32)


def _drive(sf, put, rays, depth_step):
    """The sweep through a sharded pipeline of either package."""
    g = sf.init()
    for b in range(0, 8, K):
        fb = FRAMES[b:b + K]
        g = sf.step_batch_depth(
            g, put(np.stack([f.depth_q for f in fb])),
            put(np.stack([f.rgb565 for f in fb])),
            put(np.array([f.count for f in fb], np.int32)),
            put(np.stack([f.pose for f in fb])), rays)
        if refine_due(b + K, K, CFG):
            g = sf.refine(g)
    f = FRAMES[8]
    if depth_step:
        g = sf.step_depth(g, put(f.depth_q), put(f.rgb565),
                          put(np.array(f.count, np.int32)), put(f.pose),
                          rays)
    else:
        g = sf.integrate(g, put(f.points_f32), put(_rgb(f)),
                         put(f.depth_q > 0), put(f.pose))
    return sf.refine(g)


@pytest.fixture(scope="module", params=CASES)
def runs(request):
    n = int(request.param[1])
    route = request.param.endswith("routed")
    depth_step = request.param in ("n2-replicated", "n4-routed")
    sf = ShardedFusion(CFG, shard_devices("cpu", n), route=route)
    g = _drive(sf, lambda a: torch.from_numpy(np.asarray(a)),
               sf.put_rays(RAYS), depth_step)
    js = JaxSharded(JCFG, n_devices=n, route=route)
    jg = _drive(js, jnp.asarray, js.put_rays(RAYS), depth_step)
    return sf, g, js, jg


def test_extract_matches_jax(runs):
    sf, g, js, jg = runs
    a, b = sf.extract(g).to_host(), js.extract(jg).to_host()
    assert a["cell"].dtype == np.int64 and a["cell"].size > 500
    for f in ("cell", "count", "n_pts"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert np.all(np.diff(a["cell"]) > 0)
    for f in ("centroid", "normal", "sd", "mean_dist", "sd_dist"):
        np.testing.assert_allclose(a[f], b[f], atol=1e-5, err_msg=f)
    np.testing.assert_allclose(a["rgb"], b["rgb"], rtol=1e-6)
    assert sf.extract(g).n_valid == a["cell"].size


def test_metrics_match_jax(runs):
    sf, g, js, jg = runs
    m = sf.metrics(g)
    assert m == js.metrics(jg)
    assert m["devices"] == sf.n and m["frames"] == len(FRAMES)
    assert all(v == 0 for k, v in m.items() if k.startswith("overflow"))


def test_shard_grids_match_jax(runs):
    sf, g, js, jg = runs
    fields = {f: np.asarray(getattr(jg, f)) for f in jg._fields}
    assert dataclasses.asdict(sf.config) == dataclasses.asdict(js.config)
    for j in range(sf.n):
        want = checks.by_cell(
            {f: (a[j] if f in SCALARS or a.ndim == 1 and a.size == sf.n
                 else np.split(a, sf.n, axis=1 if f == "buf_pts" else 0)[j])
             for f, a in fields.items()}, js.config)
        got = checks.by_cell(convert.grid_to_jax(g[j], sf.config),
                             sf.config)
        assert got["cell"].size > 100
        for f in ("cell", "n_pts", "normal_found", "dep_count", "dep",
                  "viewpoint", "occ_bits", "buffer") + SCALARS:
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"shard {j} {f}")
        np.testing.assert_allclose(got["normal"], want["normal"], atol=1e-5)
        np.testing.assert_allclose(got["rgb_sum"], want["rgb_sum"],
                                   rtol=1e-6)
        ok, err = checks.cyl_stats_error(got["cyl_stats"],
                                         want["cyl_stats"],
                                         CFG.cylinder_radius)
        assert ok, (j, err)


def test_routed_drops_are_counted_as_jax_counts():
    """A budget far under the load drops points; both packages drop the
    same lanes and book them once, in ``overflow_active``."""
    sf = ShardedFusion(CFG, shard_devices("cpu", 4), route=True,
                       route_betas=(0.05,))
    js = JaxSharded(JCFG, n_devices=4, route=True, route_beta=0.05)
    g, jg = sf.init(), js.init()
    for f in FRAMES[:2]:
        args = (f.points_f32, _rgb(f), f.depth_q > 0, f.pose)
        g = sf.integrate(g, *map(torch.from_numpy, args))
        jg = js.integrate(jg, *map(jnp.asarray, args))
    m, jm = sf.metrics(g), js.metrics(jg)
    assert m == jm and m["overflow_active"] > 0
    assert int(g[0].overflow_active) == m["overflow_active"]
    g, jg = sf.refine(g), js.refine(jg)
    a, b = sf.extract(g).to_host(), js.extract(jg).to_host()
    np.testing.assert_array_equal(a["cell"], b["cell"])
    np.testing.assert_array_equal(a["n_pts"], b["n_pts"])
    fetch = sf.extract_fetcher(g)
    for fields in (("cell",), ("cell", "n_pts")):
        got = fetch(fields)
        assert tuple(got) == fields
        for k in fields:
            np.testing.assert_array_equal(got[k], a[k])


def test_flagship_extent_shards_within_int32():
    """The launch-file bbox at 1 mm (7.8 G cells) cannot be one grid, and
    shards onto 8 local windows under the int32 cap, as in the JAX
    package."""
    kw = dict(bbox=(-0.80, 1.80, -1.5, 1.5, 0.0, 1.0),
              resolution=(0.001, 0.001, 0.001))
    flagship = FusionConfig(**kw)
    assert flagship.global_x_cells * flagship.dims[1] \
        * flagship.dims[2] >= 2 ** 31
    with pytest.raises(ValueError):
        flagship.validate()
    sf = ShardedFusion(flagship, shard_devices("cpu", 8), route=True)
    js = JaxSharded(JaxConfig(**kw), n_devices=8, route=True)
    assert (sf.slab_w, sf.halo) == (js.slab_w, js.halo) == (325, 6)
    assert sf.config.shard_x_cells == sf.slab_w + 2 * sf.halo == 337
    assert sf.config.n_cells == js.config.n_cells < 2 ** 31
    assert sf.slab_w * 8 >= flagship.global_x_cells
    assert [p.offset for p in sf.shards] == [
        (j * 325 - 6, 0, 0) for j in range(8)]
    assert sf.send_lanes_tiers == js.send_lanes_tiers
