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
from hifi_fusion_tpu_torch.models.pipeline import FusionPipeline
from hifi_fusion_tpu_torch.ops import hashing, integrate, refine
from hifi_fusion_tpu_torch.utils.synthetic import camera_rays, make_depth_sweep

pytestmark = pytest.mark.cuda

CFG = small_test_config(refine_every=4, max_batch_frames=4,
                        z_clip=(0.05, 10.0))
RAYS = camera_rays(96, 64, fx=120.0, fy=120.0)
FRAMES = make_depth_sweep(CFG, 12, width=96, height=64, srays=RAYS, seed=9,
                          noise_sd=3e-4, camera_height=0.4)


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
