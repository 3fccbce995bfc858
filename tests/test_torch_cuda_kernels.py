"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card.  Every test needs a CUDA card and skips without one.

The JAX package's ``tests/conftest.py`` imports ``jax``, which the card's
machine does not have, so run these there without it, from the root of a
checkout:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda_kernels.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from hifi_fusion_tpu_torch import checks, kernels
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.models import tsdf
from hifi_fusion_tpu_torch.models.pipeline import FusionPipeline
from hifi_fusion_tpu_torch.ops import hashing, integrate, refine, scatter
from hifi_fusion_tpu_torch.utils.synthetic import camera_rays, make_depth_sweep

pytestmark = pytest.mark.cuda

CFG = small_test_config(refine_every=4, max_batch_frames=4,
                        z_clip=(0.05, 10.0))
RAYS = camera_rays(96, 64, fx=120.0, fy=120.0)
FRAMES = make_depth_sweep(CFG, 12, width=96, height=64, srays=RAYS, seed=9,
                          noise_sd=3e-4, camera_height=0.4)
TCFG = tsdf.TsdfConfig(
    base=small_test_config(refine_every=0, max_batch_frames=4,
                           z_clip=(0.05, 10.0), capacity_log2=16,
                           max_points=RAYS.shape[1]),
    truncation=0.011, n_samples=5, min_weight=2.0)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _batch(pipe, i):
    fs = FRAMES[4 * i:4 * i + 4]
    return (pipe.put(np.stack([f.depth_q for f in fs])),
            pipe.put(np.stack([f.rgb565 for f in fs])),
            pipe.put(np.full((4,), fs[0].count, np.int32)),
            pipe.put(np.stack([f.pose for f in fs])))


@pytest.fixture(scope="module")
def state(dev):
    """A grid on the card after two batches and two refines, and the third
    batch's inputs."""
    pipe = FusionPipeline(CFG, dev)
    rays = pipe.put(RAYS)
    grid = pipe.init()
    for i in range(2):
        pipe.step_batch_depth(grid, *_batch(pipe, i), rays)
        pipe.refine(grid)
    return pipe, grid, rays, _batch(pipe, 2)


def test_depth_frontend_bit_exact(state):
    pipe, grid, rays, b = state
    n0 = kernels.LAUNCHES["depth_frontend"]
    got = integrate.depth_frontend(*b, rays, CFG)
    assert kernels.LAUNCHES["depth_frontend"] == n0 + 1
    want = integrate.depth_frontend_plain(*b, rays, CFG)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[1] != integrate.INVALID_ID).sum()) > 0


def test_hash_insert_by_id(state):
    pipe, grid, rays, b = state
    _, ids, _ = integrate.depth_frontend(*b, rays, CFG)
    uids = torch.unique(ids[ids != integrate.INVALID_ID]).to(torch.int32)
    kk, kp = grid.key.clone(), grid.key.clone()
    sk, fk = hashing.lookup_or_insert(kk, uids, CFG.max_probes, CFG.capacity)
    sp, fp = hashing.insert_plain(kp, uids, CFG.max_probes, CFG.capacity)
    assert int(fk) == int(fp) == 0
    assert torch.equal(kk[sk.long()], uids) and torch.equal(kp[sp.long()],
                                                             uids)
    assert torch.equal(torch.sort(kk).values, torch.sort(kp).values)
    # a tight probe bound: failures counted, placed ids hold their slot
    small = torch.full((256,), -1, dtype=torch.int32, device=pipe.device)
    s, f = hashing.lookup_or_insert(small, uids[:300], 8, 256)
    placed = s >= 0
    assert int(f) == int((~placed).sum()) > 0
    assert torch.equal(small[s[placed].long()], uids[:300][placed])


def test_dep_stream_matches_plain(state):
    pipe, grid, rays, b = state
    world, ids, _ = integrate.depth_frontend(*b, rays, CFG)
    sid, order = torch.sort(ids, stable=True)
    n = int((sid != integrate.INVALID_ID).sum())
    uids, run = torch.unique_consecutive(sid[:n], return_inverse=True)
    slots = hashing.lookup(grid.key, uids, CFG.max_probes, CFG.capacity)
    slot_pt = slots[run].contiguous()
    pts = world[:, order[:n]].contiguous()
    gk = dataclasses.replace(grid, cyl_stats=grid.cyl_stats.clone())
    gp = dataclasses.replace(grid, cyl_stats=grid.cyl_stats.clone())
    integrate.dep_stream(pts, slot_pt, gk, CFG)
    integrate.dep_stream_plain(pts, slot_pt, gp, CFG)
    ok, err = checks.cyl_stats_error(gk.cyl_stats.cpu().numpy(),
                                     gp.cyl_stats.cpu().numpy(),
                                     CFG.cylinder_radius)
    assert ok, err
    added = gk.cyl_stats.view(-1, 5)[:, 4] - grid.cyl_stats.view(-1, 5)[:, 4]
    assert float(added.sum()) > 0


def test_normal_fit_matches_plain(state):
    pipe, grid, rays, b = state
    g = dataclasses.replace(grid, **{f.name: getattr(grid, f.name).clone()
                                     for f in dataclasses.fields(grid)})
    integrate.integrate_batch_depth(g, *b, rays, CFG)
    cand = torch.nonzero((g.n_pts > 0) & ~g.normal_found).squeeze(1).to(
        torch.int32)
    gk = dataclasses.replace(g, normal=g.normal.clone(),
                             normal_found=g.normal_found.clone())
    gp = dataclasses.replace(g, normal=g.normal.clone(),
                             normal_found=g.normal_found.clone())
    nk, ok_k = refine.normal_fit(cand, gk, CFG)
    nplain, ok_p = refine.normal_fit_plain(cand, gp, CFG)
    assert torch.equal(ok_k, ok_p) and int(ok_k.sum()) > 0
    assert torch.equal(gk.normal_found, gp.normal_found)
    assert float((gk.normal - gp.normal).abs().max()) <= 1e-5
    assert float((nk - nplain).abs()[:, ok_k].max()) <= 1e-5


def _same_words(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.fixture(scope="module")
def tsdf_state(dev):
    """A TSDF grid on the card after two K=4 batches, and the third
    batch's inputs."""
    pipe = tsdf.TsdfPipeline(TCFG, dev)
    rays = pipe.put(RAYS)
    grid = pipe.init()
    for i in range(2):
        pipe.step_batch_depth(grid, *_batch(pipe, i), rays)
    return pipe, grid, rays, _batch(pipe, 2)


def test_tsdf_lanes_bit_exact(tsdf_state):
    pipe, grid, rays, b = tsdf_state
    n0 = kernels.LAUNCHES["tsdf_lanes"]
    got = tsdf.tsdf_lanes(*b, rays, TCFG)
    assert kernels.LAUNCHES["tsdf_lanes"] == n0 + 1
    want = tsdf.tsdf_lanes_plain(*b, rays, TCFG)
    assert all(_same_words(g, w) for g, w in zip(got, want))
    assert int((got[0] != tsdf.BIG).sum()) > 0


@pytest.mark.parametrize("n", [1, 700, 1024, 1025, None])
def test_segscan_bit_exact(tsdf_state, n):
    """Every kind on the sorted sample lanes of a batch (n=None: all of
    them, two-level), and on prefixes around the flat-ladder bound."""
    pipe, grid, rays, b = tsdf_state
    skey, vals = tsdf.tsdf_lanes(*b, rays, TCFG)
    sid, order = torch.sort(skey, stable=True)
    svals = vals[:, order][:, :n].contiguous()
    starts = scatter.segment_starts(sid, sid != tsdf.BIG)[:n].contiguous()
    words = svals.view(torch.int32)
    for kind, v in (("add", svals), ("first", svals), ("first", words),
                    ("or", words), ("add", svals[2])):
        n0 = kernels.LAUNCHES["segscan"]
        got = scatter.segment_reduce(v, starts, kind)
        assert kernels.LAUNCHES["segscan"] == n0 + 1
        assert _same_words(got, scatter.segment_reduce_plain(v, starts,
                                                             kind)), kind


def test_tsdf_surface_matches_plain(tsdf_state):
    pipe, grid, rays, b = tsdf_state
    cell, slots = tsdf.surface_cells(grid, TCFG)
    assert cell.numel() > 100
    got = tsdf.tsdf_surface(cell, slots, grid, TCFG)
    want = tsdf.tsdf_surface_plain(cell, slots, grid, TCFG)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-6
