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

from hifi_fusion_tpu_torch import checks, convert, kernels
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.grid import make_grid
from hifi_fusion_tpu_torch.models import tsdf
from hifi_fusion_tpu_torch.models.pipeline import FusionPipeline
from hifi_fusion_tpu_torch.ops import (geometry, hashing, integrate,
                                      queries, refine, scatter)
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


# owners of the adversarial K3 grid; the cells streamed through them
K3_CFG = small_test_config(cylinder_radius=0.004)
K3_OWNERS, K3_CELLS = 300, 400
# run lengths around the kernel's 32-lane warps, 128-lane chunks and
# 2048-lane CTAs
K3_RUNS = (1, 3, 31, 32, 33, 40, 97, 127, 128, 129, 300, 1000, 2047, 2049,
           2100, 5)


def _k3_inputs(dev, seed=3):
    """A grid whose point cells list owners with -1 holes and dep_count
    above D, and (3, n) points sorted by cell: runs of 1-2,100 points
    (cells over warp, chunk and CTA boundaries), broken by runs of
    unplaced (-1) lanes, each point near one of its cell's owners."""
    cfg, D = K3_CFG, K3_CFG.max_dependants
    rng = np.random.default_rng(seed)
    grid = make_grid(cfg, dev)
    n_ids = int(np.prod(cfg.dims))
    ids = rng.choice(n_ids, K3_OWNERS + K3_CELLS, replace=False)
    key = np.full(cfg.capacity, -1, np.int32)
    key[:ids.size] = ids
    nrm = rng.normal(size=(K3_OWNERS, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    normal = np.zeros((cfg.capacity, 3), np.float32)
    normal[:K3_OWNERS] = nrm
    dep = np.full((cfg.capacity, D), -1, np.int32)
    dep_count = np.zeros(cfg.capacity, np.int32)
    cells = K3_OWNERS + np.arange(K3_CELLS)
    dep[cells] = rng.integers(0, K3_OWNERS, (K3_CELLS, D))
    dep[cells] = np.where(rng.random((K3_CELLS, D)) < 0.2, -1, dep[cells])
    dep_count[cells] = rng.integers(0, D + 5, K3_CELLS)
    coords = np.stack([ids // (cfg.dims[1] * cfg.dims[2]),
                       ids // cfg.dims[2] % cfg.dims[1], ids % cfg.dims[2]],
                      axis=1)
    center = (np.asarray(cfg.origin) + np.asarray(cfg.resolution)
              * (coords + 0.5))
    pts, slots = [], []
    for i, s in enumerate(cells):
        if i % 7 == 3:                          # a run of unplaced lanes
            m = int(rng.integers(1, 300))
            pts.append(rng.uniform(-0.3, 0.3, (m, 3)))
            slots.append(np.full(m, -1))
        m = K3_RUNS[i % len(K3_RUNS)]
        listed = dep[s, :min(dep_count[s], D)]
        listed = listed[listed >= 0]
        o = rng.choice(listed, m) if listed.size else rng.integers(
            0, K3_OWNERS, m)
        u = rng.normal(size=(m, 3))
        u -= np.sum(u * nrm[o], axis=1, keepdims=True) * nrm[o]
        u /= np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-12)
        p = (center[o] + rng.uniform(-0.01, 0.01, (m, 1)) * nrm[o]
             + rng.uniform(0.0, 0.006, (m, 1)) * u)
        pts.append(p)
        slots.append(np.full(m, s))
    put = lambda a, t: torch.from_numpy(np.ascontiguousarray(a, t)).to(dev)
    grid = dataclasses.replace(
        grid, key=put(key, np.int32), normal=put(normal.reshape(-1),
                                                 np.float32),
        dep=put(dep.reshape(-1), np.int32),
        dep_count=put(dep_count, np.int32))
    return (put(np.concatenate(pts).T, np.float32),
            put(np.concatenate(slots), np.int32), grid)


def test_dep_stream_adversarial_runs(dev):
    """K3 against its plain version on long cells, cells over warp, chunk
    and CTA boundaries, -1 owner holes and dep_count > D: hits exact, the
    sums within ``checks.cyl_stats_error``."""
    pts, slots, grid = _k3_inputs(dev)
    assert pts.shape[1] > 40000
    gk = dataclasses.replace(grid, cyl_stats=grid.cyl_stats.clone())
    gp = dataclasses.replace(grid, cyl_stats=grid.cyl_stats.clone())
    n0 = kernels.LAUNCHES["dep_stream"]
    integrate.dep_stream(pts, slots, gk, K3_CFG)
    assert kernels.LAUNCHES["dep_stream"] == n0 + 1
    integrate.dep_stream_plain(pts, slots, gp, K3_CFG)
    ok, err = checks.cyl_stats_error(gk.cyl_stats.cpu().numpy(),
                                     gp.cyl_stats.cpu().numpy(),
                                     K3_CFG.cylinder_radius)
    assert ok, err
    hits = gp.cyl_stats.view(-1, 5)[:, 4]
    assert float(hits.sum()) > 10000 and int((hits > 0).sum()) > 100


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


# a grid whose z extent (37 cells) is no multiple of 32, so that columns
# start at every bit of a word
K4_CFG = dict(bbox=(-0.2, 0.2, -0.15, 0.15, -0.2, 0.17), capacity_log2=16)


def _k4_inputs(dev, k, seed=5):
    """A grid whose occupancy is four noisy planes along its faces, and the
    candidates: every occupied cell on a face, the first and last three
    cells of the grid (columns whose window starts before bit 0 or ends in
    the last word), and random occupied cells; keys at slots 0..U-1 and
    random viewpoints."""
    cfg = small_test_config(k_neighborhood=k,
                            min_neighbors=(2 * k + 1) ** 2 // 2 + 1,
                            **K4_CFG)
    rng = np.random.default_rng(seed)
    d0, d1, d2 = cfg.dims
    x, y, z = np.meshgrid(np.arange(d0), np.arange(d1), np.arange(d2),
                          indexing="ij")
    near = lambda f: np.abs(f) < 0.7
    occ = (near(z - 1 - 0.3 * x - 0.1 * y) | near(x - 1 - 0.2 * y - 0.1 * z)
           | near(y - (d1 - 2) + 0.1 * x) | near(z - (d2 - 2) + 0.2 * x)
           | (rng.random(x.shape) < 0.02)).reshape(-1)
    occ[:3] = True
    ids = np.arange(occ.size)
    face = ((x == 0) | (x == d0 - 1) | (y == 0) | (y == d1 - 1) | (z == 0)
            | (z == d2 - 1)).reshape(-1)
    inner = ids[occ & ~face]
    cand_ids = np.unique(np.concatenate([
        ids[occ & face], ids[:3], ids[-3:],
        rng.choice(inner, min(2000, inner.size), replace=False)]))
    words = np.zeros(cfg.n_occ_words, np.uint32)
    np.bitwise_or.at(words, ids[occ] >> 5,
                     np.left_shift(1, ids[occ] & 31).astype(np.uint32))
    U = cand_ids.size
    key = np.full(cfg.capacity, -1, np.int32)
    key[:U] = cand_ids
    vp = np.zeros((cfg.capacity, 3), np.float32)
    vp[:U] = rng.uniform(-0.5, 0.5, (U, 3))
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    grid = dataclasses.replace(
        make_grid(cfg, dev), key=put(key), occ_bits=put(words.view(np.int32)),
        viewpoint=put(vp.reshape(-1)))
    cand = torch.arange(U, dtype=torch.int32, device=dev)
    return cfg, cand, grid


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_normal_fit_faces(dev, k):
    """K4 against its plain version at k = 1, 2, 3 (one round of loads)
    and 4 (rounds of 32 columns), on candidates on every face of the grid,
    where columns fall outside it and windows start before bit 0: the
    gate exact, the normals within 1e-5."""
    cfg, cand, grid = _k4_inputs(dev, k)
    gk = dataclasses.replace(grid, normal=grid.normal.clone(),
                             normal_found=grid.normal_found.clone())
    gp = dataclasses.replace(grid, normal=grid.normal.clone(),
                             normal_found=grid.normal_found.clone())
    n0 = kernels.LAUNCHES["normal_fit"]
    nk, ok_k = refine.normal_fit(cand, gk, cfg)
    assert kernels.LAUNCHES["normal_fit"] == n0 + 1
    nplain, ok_p = refine.normal_fit_plain(cand, gp, cfg)
    n_ok = int(ok_k.sum())
    assert torch.equal(ok_k, ok_p) and 0 < n_ok < cand.numel()
    assert torch.equal(gk.normal_found, gp.normal_found)
    assert float((gk.normal - gp.normal).abs().max()) <= 1e-5
    assert float((nk - nplain).abs().max()) <= 1e-5


def _disjoint_new_ids(key, ids, max_probes):
    """The ids none of whose first ``max_probes`` probe slots is the probe
    slot of another id kept, so that which id claims a slot does not
    depend on the order the ids arrive in."""
    C = key.numel()
    h = hashing.hash_u32(ids.cpu()).numpy()
    j = np.arange(max_probes)
    seq = (h[:, None] + (j * (j + 1) // 2)[None, :]) & (C - 1)
    taken, keep = set(), []
    for i, row in enumerate(seq.tolist()):
        if taken.isdisjoint(row):
            taken.update(row)
            keep.append(i)
    return ids[torch.tensor(keep, device=ids.device)]


def test_hash_insert_full_table(dev):
    """K2 into a 2^12-slot table filled to 0.9 under max_probes = 4: ids
    already there within the bound and new ids whose probe slots are
    disjoint.  Every placed
    id at its slot, the same id set as the plain version, failures equal
    to the unplaced ids, and the failures added into a passed counter
    equal to the returned count; with all new ids racing for slots, one
    call's failures still equal its unplaced ids."""
    C, P = 1 << 12, 4
    rng = np.random.default_rng(11)
    pool = torch.from_numpy(rng.choice(2 ** 30, 3 * C, replace=False)
                            .astype(np.int32)).to(dev)
    table = torch.full((C,), -1, dtype=torch.int32, device=dev)
    hashing.insert_plain(table, pool[:int(0.9 * C)], C, C)
    assert int((table >= 0).sum()) == int(0.9 * C)
    # ids the fill placed within the first P probes (the rest lie beyond
    # the bound and count as unplaced, as they would for any caller)
    held = table[table >= 0]
    present = held[hashing.lookup(table, held, P, C) >= 0][:500]
    new = _disjoint_new_ids(table, pool[C:], P)
    ids = torch.cat([present, new])
    kk, kp, kc = table.clone(), table.clone(), table.clone()
    sk, fk = hashing.lookup_or_insert(kk, ids, P, C)
    sp, fp = hashing.insert_plain(kp, ids, P, C)
    counter = torch.full((), 7, dtype=torch.int32, device=dev)
    sc = hashing.lookup_or_insert(kc, ids, P, C, counter)
    placed = sk >= 0
    assert int(fk) == int(fp) == int((~placed).sum()) > 0
    assert int(counter) == 7 + int(fk)
    assert torch.equal(kk[sk[placed].long()], ids[placed])
    assert torch.equal(sk, sp) and torch.equal(sc, sk)
    assert torch.equal(torch.sort(kk).values, torch.sort(kp).values)
    assert torch.equal(kc, kk)
    assert bool((sk[:present.numel()] >= 0).all())
    # every new id races: one call's failures equal its unplaced ids, and
    # the table holds what it held and the placed ids, once each
    race = pool[C:]
    kr = table.clone()
    counter.zero_()
    sr = hashing.lookup_or_insert(kr, race, P, C, counter)
    ok = sr >= 0
    assert int(counter) == int((~ok).sum()) > 0
    assert torch.equal(kr[sr[ok].long()], race[ok])
    want = torch.cat([table[table >= 0], race[ok]])
    assert torch.equal(torch.sort(kr[kr >= 0]).values,
                       torch.sort(want).values)


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


# > 2^11 blocks of 512 (12 summary steps), not a multiple of 512
ADV_N = 2149 * 512 - 475


@pytest.mark.parametrize("n", [1, 700, 1024, 1025, None,
                               *checks.SEGSCAN_PATTERNS])
def test_segscan_bit_exact(tsdf_state, n):
    """Every kind on the sorted sample lanes of a batch (n=None: all of
    them, two-level), on prefixes around the flat-ladder bound, and on
    the adversarial flag patterns of ``checks.segscan_case`` at ADV_N
    lanes (n names the pattern)."""
    pipe, grid, rays, b = tsdf_state
    if isinstance(n, str):
        cases = []
        # k = 8 and 13: block-pass CTAs of 8 and 13 warps, one a channel
        for kind, dtype, k in (("add", np.float32, 6),
                               ("first", np.float32, 2),
                               ("first", np.int32, 1), ("or", np.int32, 3),
                               ("first", np.int32, 8),
                               ("add", np.float32, 13)):
            vals, flags = checks.segscan_case(n, kind, dtype, k, ADV_N,
                                              seed=k)
            v = torch.from_numpy(vals).to(pipe.device)
            cases.append((kind, v, torch.from_numpy(flags).to(pipe.device)))
        cases.append(("add", cases[0][1][2].contiguous(), cases[0][2]))
    else:
        skey, vals = tsdf.tsdf_lanes(*b, rays, TCFG)
        sid, order = torch.sort(skey, stable=True)
        svals = vals[:, order][:, :n].contiguous()
        starts = scatter.segment_starts(sid, sid != tsdf.BIG)[:n] \
            .contiguous()
        words = svals.view(torch.int32)
        cases = [(kind, v, starts) for kind, v in (
            ("add", svals), ("first", svals), ("first", words),
            ("or", words), ("add", svals[2]))]
    for kind, v, starts in cases:
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


def _planar_inputs(dev, K, n, pw, cw, mw, seed):
    """K frames of n lanes for K5: world points on cell faces, inside
    cells, exactly on the bbox faces and one ulp inside them, beyond the
    bbox and beyond the z clip, seen from look-down and general poses, on
    the wires ``pw`` (f32, q16), ``cw`` (f32, u32, 565) and ``mw`` (bool,
    count)."""
    from hifi_fusion_tpu_torch.utils.synthetic import Frame, pack_frame_q16
    rng = np.random.default_rng(seed)
    f32 = np.float32
    res = f32(CFG.resolution[0])
    b = CFG.bbox
    lo, hi = np.asarray(b[0::2], f32), np.asarray(b[1::2], f32)
    c = rng.integers(-2, max(CFG.dims) + 2, (K, 3, n))
    w = (np.asarray(CFG.origin, f32)[None, :, None] + c.astype(f32) * res
         ).astype(f32)
    w[:, :, ::3] += (rng.random(w[:, :, ::3].shape) * res).astype(f32)
    edge = [lo, hi, np.nextafter(lo, f32(1)), np.nextafter(hi, f32(-1))]
    for i in range(0, n, 11):
        a = rng.integers(0, 3)
        w[:, a, i] = edge[(i // 11) % 4][a]
    pts, poses, quant = [], [], []
    for k in range(K):
        pose = np.eye(4)
        if k % 3 == 2:              # a general rotation
            q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
            pose[:3, :3] = q * np.sign(np.linalg.det(q))
        else:
            pose[1, 1] = pose[2, 2] = -1.0
        pose[:3, 3] = [0.01 * k, -0.02, 0.5]
        cam = (pose[:3, :3].T @ (w[k].astype(np.float64)
                                 - pose[:3, 3:])).astype(f32)
        cam[2, ::17] = 20.0          # beyond the z clip
        if pw == "q16":
            p = pack_frame_q16(Frame(np.ascontiguousarray(cam.T),
                                     np.zeros((n, 3), f32), pose.astype(f32),
                                     np.ones(n, bool)), n)
            cam, q = p.points_q, p.quant
            quant.append(q)
        pts.append(cam)
        poses.append(pose.astype(f32))
    rgb8 = rng.integers(0, 256, (K, 3, n))
    if cw == "f32":
        rgb = rgb8.astype(f32)
    elif cw == "u32":
        r = rgb8.astype(np.uint32)
        rgb = (r[:, 0] << 16) | (r[:, 1] << 8) | r[:, 2]
    else:
        rgb = rng.integers(0, 1 << 16, (K, n)).astype(np.uint16)
    mask = (rng.random((K, n)) < 0.9 if mw == "bool"
            else rng.integers(0, n + 1, K).astype(np.int32))
    put = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
           for a in (np.stack(pts), rgb, mask, np.stack(poses))]
    q = torch.from_numpy(np.stack(quant)).to(dev) if quant else None
    return put, q


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("wires", ["f32-f32-bool", "f32-u32-count",
                                   "f32-565-bool", "q16-f32-count",
                                   "q16-u32-bool", "q16-565-count"])
def test_planar_frontend_bit_exact(dev, K, wires):
    pw, cw, mw = wires.split("-")
    (pts, rgb, mask, poses), quant = _planar_inputs(dev, K, 4099, pw, cw,
                                                    mw, seed=K + len(wires))
    n0 = kernels.LAUNCHES["planar_frontend"]
    got = integrate.planar_frontend(pts, rgb, mask, poses, CFG, quant)
    assert kernels.LAUNCHES["planar_frontend"] == n0 + 1
    q = None if quant is None else quant
    want = integrate.planar_frontend_plain(pts, rgb, mask, poses, q, CFG)
    assert all(_same_words(g, w) for g, w in zip(got, want))
    n_valid = int((got[1] != integrate.INVALID_ID).sum())
    assert 0 < n_valid < got[1].numel()


def test_tsdf_surface_bit_exact_config5(dev):
    """T3 against its plain version, bit for bit, on the surface of a
    TSDF config-5 grid (0.8 mm pitch, 2^24 slots) after two K=8 batches of
    the seeded 640x480 sweep."""
    from hifi_fusion_tpu_torch.config import FusionConfig
    base = FusionConfig(
        max_batch_frames=8, bbox=(-0.35, 0.35, -0.35, 0.35, 0.0, 0.4),
        resolution=(0.0008, 0.0008, 0.0008), capacity_log2=24,
        max_points=640 * 480, max_unique_per_frame=1 << 19,
        refine_every=0, z_clip=(0.28, 0.6)).validate()
    tcfg = tsdf.TsdfConfig(base=base, n_samples=11, batch_unique=1 << 21)
    rays_np = camera_rays(640, 480, fx=900.0, fy=900.0)
    frames = make_depth_sweep(base, 16, width=640, height=480, seed=0,
                              srays=rays_np, arc_frames=100)
    pipe = tsdf.TsdfPipeline(tcfg, dev)
    rays, grid = pipe.put(rays_np), pipe.init()
    for i in range(2):
        fs = frames[8 * i:8 * i + 8]
        pipe.step_batch_depth(
            grid, pipe.put(np.stack([f.depth_q for f in fs])),
            pipe.put(np.stack([f.rgb565 for f in fs])),
            pipe.put(np.full((8,), fs[0].count, np.int32)),
            pipe.put(np.stack([f.pose for f in fs])), rays)
    cell, slots = tsdf.surface_cells(grid, tcfg)
    assert cell.numel() > 50_000
    n0 = kernels.LAUNCHES["tsdf_surface"]
    got = tsdf.tsdf_surface(cell, slots, grid, tcfg)
    assert kernels.LAUNCHES["tsdf_surface"] == n0 + 1
    want = tsdf.tsdf_surface_plain(cell, slots, grid, tcfg)
    assert all(_same_words(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("mw", ["bool", "count"])
def test_tsdf_lanes_planar_bit_exact(dev, K, mw):
    """T2p against its plain version, bit for bit, on points whose world
    images sit on cell faces, at the bbox and outside the z clip, with a
    lane mask and with count prefixes."""
    (pts, rgb, mask, poses), _ = _planar_inputs(dev, K, 4099, "f32", "f32",
                                                mw, seed=K + len(mw))
    n0 = kernels.LAUNCHES["tsdf_lanes_planar"]
    got = tsdf.tsdf_lanes_planar(pts, rgb, mask, poses, TCFG)
    assert kernels.LAUNCHES["tsdf_lanes_planar"] == n0 + 1
    want = tsdf.tsdf_lanes_planar_plain(pts, rgb, mask, poses, TCFG)
    assert all(_same_words(g, w) for g, w in zip(got, want))
    n_valid = int((got[0] != tsdf.BIG).sum())
    assert 0 < n_valid < got[0].numel()


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4])
def test_neighbor_count_faces(dev, k):
    """B11 against the bitmap form in plain PyTorch on K4's face grid:
    windows cut by every face of the grid and starting before bit 0, an
    empty slot (key -1), slots of -1 and below, and a slot past the
    table."""
    cfg, cand, grid = _k4_inputs(dev, max(k, 1))
    extra = torch.tensor([cand.numel(), -1, -7, cfg.capacity + 3],
                         dtype=torch.int32, device=dev)
    slots = torch.cat([cand, extra])
    n0 = kernels.LAUNCHES["neighbor_count"]
    got = queries.occupied_neighbor_counts(grid, slots, cfg, radius_cells=k)
    assert kernels.LAUNCHES["neighbor_count"] == n0 + 1
    want = queries.neighbor_counts_bitmap(grid, slots, cfg, k)
    assert torch.equal(got, want)
    # a window of one cell counts at most that cell
    assert int(got.max()) > (1 if k else 0) and got[-3:-1].tolist() == [0, 0]


def test_neighbor_count_matches_lookup(state):
    """B11 against the plain version (the JAX package's lookup form) over
    every slot of a fused grid, and the ROR mask the same on the card and
    on the CPU."""
    pipe, grid, rays, b = state
    slots = torch.arange(CFG.capacity, dtype=torch.int32, device=pipe.device)
    slots = torch.where(grid.n_pts > 0, slots, torch.full_like(slots, -1))
    for r in (1, 2):
        got = queries.occupied_neighbor_counts(grid, slots, CFG, r)
        want = queries.neighbor_counts_plain(grid, slots, CFG, r)
        assert torch.equal(got, want) and int(got.max()) > 1
    keep = queries.radius_outlier_mask(grid, CFG).cpu()
    cpu = dataclasses.replace(grid, **{
        f.name: getattr(grid, f.name).cpu()
        for f in dataclasses.fields(grid)})
    assert torch.equal(keep, queries.radius_outlier_mask(cpu, CFG))


# -- the shard offset and kernel B12 -----------------------------------------

# 128 x cells at 5 mm: slabs of 16 cells and more for n <= 8 (halo 6)
ROUTE_CFG = small_test_config(resolution=(0.005,) * 3, z_clip=(0.05, 10.0),
                              max_points=RAYS.shape[1], capacity_log2=16)


@pytest.fixture(scope="module")
def shard_state(dev):
    """A 2-shard replicated grid on the card after two batches and two
    refines, and the third batch's inputs."""
    from hifi_fusion_tpu_torch.parallel.sharding import ShardedFusion
    sf = ShardedFusion(ROUTE_CFG, [dev, dev])
    rays = sf.put_rays(RAYS)
    grid = sf.init()
    for i in range(2):
        sf.step_batch_depth(grid, *_batch(sf, i), rays)
        sf.refine(grid)
    return sf, grid, rays, _batch(sf, 2)


@pytest.mark.parametrize("j", [0, 1])
def test_depth_frontend_offset_bit_exact(shard_state, j):
    sf, grid, rays, b = shard_state
    p = sf.shards[j]
    got = integrate.depth_frontend(*b, rays, p.config, p.offset)
    want = integrate.depth_frontend_plain(*b, rays, p.config, p.offset)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[1] != integrate.INVALID_ID).sum()) > 0


@pytest.mark.parametrize("pre", [False, True])
def test_planar_frontend_offset_bit_exact(dev, pre):
    """K5 with a shard's offset, on camera points and on the world wire
    a router hands a shard (``pre_transformed``)."""
    from hifi_fusion_tpu_torch.parallel.sharding import ShardedFusion
    sf = ShardedFusion(CFG, [dev] * 2)
    (pts, rgb, mask, poses), _ = _planar_inputs(dev, 4, 4099, "f32", "f32",
                                                "bool", seed=21)
    if pre:
        from hifi_fusion_tpu_torch.ops.geometry import transform_points
        pts = transform_points(pts, poses).contiguous()
    for p in sf.shards:
        got = integrate.planar_frontend(pts, rgb, mask, poses, p.config,
                                        offset=p.offset,
                                        pre_transformed=pre)
        want = integrate.planar_frontend_plain(pts, rgb, mask, poses, None,
                                               p.config, p.offset, pre)
        assert all(_same_words(g, w) for g, w in zip(got, want))
        n_valid = int((got[1] != integrate.INVALID_ID).sum())
        assert 0 < n_valid < got[1].numel()


@pytest.mark.parametrize("j", [0, 1])
def test_dep_stream_and_normal_fit_on_a_shard(shard_state, j):
    """K3 and K4 on a shard's grid: owner centers and the orientation take
    the shard's offset."""
    sf, grid, rays, b = shard_state
    p, g = sf.shards[j], grid[j]
    world, ids, _ = integrate.depth_frontend(*b, rays, p.config, p.offset)
    sid, order = torch.sort(ids, stable=True)
    n = int((sid != integrate.INVALID_ID).sum())
    uids, run = torch.unique_consecutive(sid[:n], return_inverse=True)
    slot_pt = hashing.lookup(g.key, uids, p.config.max_probes,
                             p.config.capacity)[run].contiguous()
    pts = world[:, order[:n]].contiguous()
    gk = dataclasses.replace(g, cyl_stats=g.cyl_stats.clone())
    gp = dataclasses.replace(g, cyl_stats=g.cyl_stats.clone())
    integrate.dep_stream(pts, slot_pt, gk, p.config, p.offset)
    integrate.dep_stream_plain(pts, slot_pt, gp, p.config, p.offset)
    ok, err = checks.cyl_stats_error(gk.cyl_stats.cpu().numpy(),
                                     gp.cyl_stats.cpu().numpy(),
                                     p.config.cylinder_radius)
    assert ok, err
    assert float((gk.cyl_stats - g.cyl_stats).view(-1, 5)[:, 4].sum()) > 0
    integrate.integrate_batch_depth(gk, *b, rays, p.config, p.offset)
    cand = torch.nonzero((gk.n_pts > 0) & ~gk.normal_found).squeeze(1).to(
        torch.int32)
    gn = dataclasses.replace(gk, normal=gk.normal.clone(),
                             normal_found=gk.normal_found.clone())
    gq = dataclasses.replace(gk, normal=gk.normal.clone(),
                             normal_found=gk.normal_found.clone())
    nk, ok_k = refine.normal_fit(cand, gn, p.config, p.offset)
    nplain, ok_p = refine.normal_fit_plain(cand, gq, p.config, p.offset)
    assert torch.equal(ok_k, ok_p) and int(ok_k.sum()) > 0
    assert float((gn.normal - gq.normal).abs().max()) <= 1e-5


def _bucket_loads(r):
    """(n, K, n) kept lanes of each (destination, frame, source) bucket,
    from ``present``."""
    n, K, R = r.present.shape
    return r.present.view(n, K, n, R // n).sum(-1)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("wire", ["depth", "planar-bool", "planar-count"])
@pytest.mark.parametrize("budget", ["default", "drop", "exact", "odd", "k1"])
def test_route_pack_bit_exact(dev, n, wire, budget):
    """B12 against its plain pair on K=4 batches (K=1 with ``k1``): world,
    rgb and present in the destinations' layout bit for bit, the budget,
    the drops and the largest bucket; with the default tiers (lossless),
    a 128-lane budget (``drop``: drops wherever a bucket holds more), a
    lower tier equal to the largest bucket (``exact``: chosen, nothing
    dropped) and a budget that is no multiple of 4 (``odd``: the fill's
    scalar rows).  Lossless at K=4, some bucket loads are no multiple of
    4 and put the fill's float4 edge inside a row."""
    from hifi_fusion_tpu_torch.parallel import routing
    from hifi_fusion_tpu_torch.parallel.sharding import ShardedFusion
    sf = ShardedFusion(ROUTE_CFG, [dev] * n, route=True,
                       route_betas=(0.05,) if budget == "drop" else None)
    if wire == "depth":
        b = _batch(sf, 1)
        rays = sf.put_rays(RAYS)
        pc, rgb, mask = routing.depth_lanes(*b[:3], rays)
        lanes = (pc, rgb, mask, b[3])

        def kern(k, args):
            return routing.route_pack_depth(*(t[:k] for t in b), rays,
                                            *args)
    else:
        (pts, rgb, mask, poses), _ = _planar_inputs(
            dev, 4, 4096, "f32", "f32", wire.split("-")[1], seed=n)
        lm = mask if mask.dtype == torch.bool else (
            torch.arange(4096, device=dev)[None, :] < mask[:, None])
        lanes = (pts, rgb, lm, poses)

        def kern(k, args):
            return routing.route_pack(*(t[:k] for t in (pts, rgb, mask,
                                                         poses)), *args)
    K = 1 if budget == "k1" else 4
    tiers = sf.send_lanes_tiers
    args = (ROUTE_CFG, n, sf.slab_w, sf.halo, tiers)
    want = routing.route_pack_plain(*(t[:K] for t in lanes), *args)
    mx = want.max_bucket
    if budget == "exact":
        tiers = (mx, mx + 128)
    elif budget == "odd":
        tiers = (mx + 1 if (mx + 1) % 4 else mx + 2,)
    if tiers != sf.send_lanes_tiers:
        args = (ROUTE_CFG, n, sf.slab_w, sf.halo, tiers)
        want = routing.route_pack_plain(*(t[:K] for t in lanes), *args)
    n0 = kernels.LAUNCHES["route_pack"]
    got = kern(K, args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["route_pack"] == n0 + 1
    for g, w in zip(got[:2], want[:2]):
        assert _same_words(g, w)
    assert torch.equal(got.present, want.present)
    assert got.world.shape == (n, K, 3, n * got.send_lanes)
    assert tuple(got[3:]) == tuple(want[3:])
    assert got.max_bucket > 0
    assert (got.n_dropped > 0) == (got.max_bucket > got.send_lanes)
    if budget in ("exact", "odd"):
        assert got.send_lanes == tiers[0] and got.n_dropped == 0
    if K == 4 and budget != "drop":     # there every bucket fills 128
        assert bool(((_bucket_loads(got) % 4) != 0).any())


def _grid_copy(g):
    return dataclasses.replace(g, **{f.name: getattr(g, f.name).clone()
                                     for f in dataclasses.fields(g)})


def _cells(g, slots):
    """The cell id at each slot, -1 where the slot is -1."""
    return torch.where(slots >= 0, g.key[slots.clamp(min=0).long()], -1)


def test_hash_insert_sentinel_lanes(state):
    """K2 on a budget-sized array: INVALID_ID lanes get slot -1 and are
    not counted, the ids between them are placed as the plain version
    places them."""
    pipe, grid, rays, b = state
    _, ids, _ = integrate.depth_frontend(*b, rays, CFG)
    uids = torch.unique(ids[ids != hashing.INVALID_ID]).to(torch.int32)
    lanes = torch.full((3 * uids.numel(),), hashing.INVALID_ID,
                       dtype=torch.int32, device=pipe.device)
    lanes[1::3] = uids
    kk, kp = grid.key.clone(), grid.key.clone()
    sk, fk = hashing.lookup_or_insert(kk, lanes, CFG.max_probes,
                                      CFG.capacity)
    sp, fp = hashing.insert_plain(kp, lanes, CFG.max_probes, CFG.capacity)
    assert int(fk) == int(fp) == 0
    for s in (sk, sp):
        assert bool((s[0::3] == -1).all()) and bool((s[2::3] == -1).all())
    assert torch.equal(kk[sk[1::3].long()], uids)
    assert torch.equal(torch.sort(kk).values, torch.sort(kp).values)


@pytest.mark.parametrize("frac", [0.0, 0.37, 1.0])
def test_hash_insert_live_count(state, frac):
    """K2 on ids packed before a device-side live count, with ids past it
    that no grid cell has: only the ids before the count reach the table,
    as the plain version places them, and no failure is counted."""
    pipe, grid, rays, b = state
    _, ids, _ = integrate.depth_frontend(*b, rays, CFG)
    uids = torch.unique(ids[ids != hashing.INVALID_ID]).to(torch.int32)
    n = int(frac * uids.numel())
    stale = torch.arange(uids.numel(), dtype=torch.int32,
                         device=pipe.device) + (1 << 30)
    lanes = torch.cat([uids[:n], stale[n:]])
    n_live = torch.tensor(n, dtype=torch.int32, device=pipe.device)
    kk, kp = grid.key.clone(), grid.key.clone()
    fk, fp = (torch.zeros((), dtype=torch.int32, device=pipe.device)
              for _ in range(2))
    sk = hashing.lookup_or_insert(kk, lanes, CFG.max_probes, CFG.capacity,
                                  fk, n_live=n_live)
    sp = hashing.insert_plain(kp, lanes, CFG.max_probes, CFG.capacity, fp,
                              n_live)
    assert int(fk) == int(fp) == 0
    assert torch.equal(kk[sk[:n].long()], uids[:n])
    assert bool((sp[n:] == -1).all())
    assert torch.equal(torch.sort(kk).values, torch.sort(kp).values)
    assert not bool(torch.isin(stale[n:], kk).any())


@pytest.mark.parametrize("case", ["full", "active_budget", "buffer_full",
                                  "k1"])
def test_integrate_lanes_matches_plain(state, case):
    """B3 against its plain version on the third batch's sorted lanes: the
    grid by cell id (every integer field, the integer-valued sums, the
    buffer in order) and the sorted points and slots K3 takes."""
    pipe, grid, rays, b = state
    k = 1 if case == "k1" else 4
    b = tuple(t[:k].contiguous() for t in b)
    world, ids, rgb = integrate.depth_frontend(*b, rays, CFG)
    sid, order = torch.sort(ids, stable=True)
    n_act = int((sid != hashing.INVALID_ID).sum())
    M = ids.numel()
    NA = min(k * CFG.max_active_points, M)
    if case == "active_budget":
        NA = n_act // 2
    gk, gp = _grid_copy(grid), _grid_copy(grid)
    if case == "buffer_full":
        for g in (gk, gp):
            g.buf_count.fill_(CFG.buffer_capacity - NA + 1)
    n0 = kernels.LAUNCHES["integrate_lanes"]
    pk, sk = integrate.aggregate_lanes(gk, sid, order, world, rgb, b[3],
                                       M // k, NA, CFG, extra_dropped=3)
    pp, sp = integrate.aggregate_lanes_plain(gp, sid, order, world, rgb,
                                             b[3], M // k, NA, CFG, 3)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["integrate_lanes"] == n0 + 1
    assert _same_words(pk, pp)
    assert torch.equal(_cells(gk, sk), _cells(gp, sp))
    problems = checks.grid_problems(convert.grid_to_numpy(gk),
                                    convert.grid_to_numpy(gp), CFG)
    assert not problems, problems
    before = int(grid.overflow_active)
    assert int(gk.overflow_active) - before == max(n_act - NA, 0) + 3
    if case == "buffer_full":
        assert int(gk.overflow_buf) > int(grid.overflow_buf)
        assert int(gk.buf_count) == CFG.buffer_capacity - NA + 1
    else:
        assert int(gk.buf_count) > int(grid.buf_count)
    assert float((gk.n_pts - grid.n_pts).sum()) == min(n_act, NA)


def _refine_inputs(state, cap=False):
    """The refine after the third batch up to B6: the grid with the
    batch integrated (D - 1 dependants in every list with ``cap``), its
    candidates and their normal fit."""
    pipe, grid, rays, b = state
    g0 = _grid_copy(grid)
    integrate.integrate_batch_depth(g0, *b, rays, CFG)
    D = CFG.max_dependants
    if cap:
        g0.dep_count.copy_(torch.where(g0.key >= 0,
                                       g0.dep_count.clamp(min=D - 1),
                                       g0.dep_count))
    cand = torch.nonzero((g0.n_pts > 0) & ~g0.normal_found).squeeze(1).to(
        torch.int32)
    nvec, gated = refine.normal_fit(cand, g0, CFG)
    return g0, cand, nvec, gated


def _replay_inputs(state):
    """B7's inputs on the refine after the third batch: the grid after
    B6, the candidates, their normals, B6's links and the slot-sorted
    buffer."""
    g0, cand, nvec, gated = _refine_inputs(state)
    links = refine.refine_lines(cand, nvec, gated, g0, CFG)
    bslot, bpts = refine.sorted_buffer(g0, int(g0.buf_count))
    return g0, cand, nvec, links, bslot, bpts


def _replay_both(g, links, cand, nvec, bslot, bpts, cfg=CFG, offset=None,
                 table=None):
    """B7 and its plain version on copies of ``g``, each given its own
    copy of the runs ``table`` where one is passed; returns both
    grids."""
    gk, gp = _grid_copy(g), _grid_copy(g)
    tk, tp = (None, None) if table is None else (table.clone(),
                                                 table.clone())
    refine.buffer_replay(links, cand, nvec, bslot, bpts, gk, cfg, offset,
                         tk)
    refine.buffer_replay_plain(links, cand, nvec, bslot, bpts, gp, cfg,
                               offset, tp)
    torch.cuda.synchronize()
    return gk, gp


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _hits(g, g0):
    return float((g.cyl_stats.view(-1, 5)[:, 4]
                  - g0.cyl_stats.view(-1, 5)[:, 4]).sum())


@pytest.mark.parametrize("cap", [False, True])
def test_refine_lines_and_replay_match_plain(state, cap):
    """B6 against its plain version on the refine after the third batch
    (dependant lists in order, counts, the owner-major links by cell),
    with D binding when ``cap`` fills every list to D - 1; then B7 on
    B6's links against its plain version: ``cyl_stats`` bit-equal (both
    sum in one order), hence hit counts exact and sums under
    cyl_stats_error."""
    g0, cand, nvec, gated = _refine_inputs(state, cap)
    gk, gp = _grid_copy(g0), _grid_copy(g0)
    n0 = kernels.LAUNCHES["refine_lines"]
    lk = refine.refine_lines(cand, nvec, gated, gk, CFG)
    lp = refine.refine_lines_plain(cand, nvec, gated, gp, CFG)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["refine_lines"] == n0 + 1
    problems = checks.grid_problems(convert.grid_to_numpy(gk),
                                    convert.grid_to_numpy(gp), CFG)
    assert not problems, problems
    # the links by cell: a new ghost cell may take another slot in each
    # run (K2's race)
    assert lk.shape == (cand.numel(), CFG.n_line)
    assert torch.equal(_cells(gk, lk), _cells(gp, lp))
    n_links = int((lk >= 0).sum())
    assert n_links > 0
    assert (int(gk.overflow_dep) > int(g0.overflow_dep)) == cap

    bslot, bpts = refine.sorted_buffer(gk, int(gk.buf_count))
    n0 = kernels.LAUNCHES["buffer_replay"]
    rk, rp = _replay_both(gk, lk, cand, nvec, bslot, bpts)
    assert kernels.LAUNCHES["buffer_replay"] == n0 + 1
    assert _same_bits(rk.cyl_stats, rp.cyl_stats)
    ok, err = checks.cyl_stats_error(rk.cyl_stats.cpu().numpy(),
                                     rp.cyl_stats.cpu().numpy(),
                                     CFG.cylinder_radius)
    assert ok, err
    assert _hits(rk, gk) > 0


def test_buffer_replay_repeat_bit_identical(state):
    """Two B7 launches on copies of one grid with the same links give
    bit-identical ``cyl_stats`` (no atomics: each owner's sums in one
    fixed order, added once), equal to the plain version's."""
    g, cand, nvec, links, bslot, bpts = _replay_inputs(state)
    got = []
    for _ in range(2):
        gk = _grid_copy(g)
        refine.buffer_replay(links, cand, nvec, bslot, bpts, gk, CFG)
        got.append(gk.cyl_stats)
    torch.cuda.synchronize()
    assert _same_bits(*got)
    assert _hits(dataclasses.replace(g, cyl_stats=got[0]), g) > 0
    gp = _grid_copy(g)
    refine.buffer_replay_plain(links, cand, nvec, bslot, bpts, gp, CFG)
    assert _same_bits(got[0], gp.cyl_stats)


def _long_runs(g, links, rng):
    """A slot-sorted buffer of runs 1 to 1000 points long in the line
    cells of the first written links, the points spread over each cell."""
    slots = torch.unique(links[links >= 0])[:40]
    lens = np.resize([1, 2, 7, 8, 9, 31, 32, 33, 100, 1000], slots.numel())
    bslot = torch.repeat_interleave(slots, torch.from_numpy(lens).to(
        slots.device))
    center = geometry.center_of_ids(g.key[bslot.long()], CFG)
    half = CFG.resolution[0] / 2
    noise = rng.uniform(-half, half, (3, bslot.numel())).astype(np.float32)
    return bslot, (center + torch.from_numpy(noise).to(center.device)
                   ).contiguous()


B7_CASES = ("ghost", "revisit", "capped", "long_run", "narrow", "wide",
            "no_candidates", "no_buffer", "offset", "stale_table",
            "garbage_table")


@pytest.mark.parametrize("case", B7_CASES)
def test_buffer_replay_edge_shapes(state, case):
    """B7 against its plain version, ``cyl_stats`` bit-equal: links only
    to ghost cells (no buffered point: nothing added), a line visiting
    one cell at two steps (both replay), links capped by D (-1), runs up
    to 1000 points (much longer than a group), L = 3 (fewer steps than a
    group of 4) and L = 35 (more steps than a group of 32), no
    candidates, no buffer, a shard's offset, a runs table that holds the
    runs of another buffer over the same cells, and one of random
    values in and around the buffer's lanes."""
    g, cand, nvec, links, bslot, bpts = _replay_inputs(state)
    rng = np.random.default_rng(B7_CASES.index(case))
    cfg, offset, table = CFG, None, None
    U = cand.numel()
    has_run = torch.isin(links, bslot)
    if case == "ghost":
        links = torch.where(has_run, -1, links)
        assert bool((links >= 0).any())
    elif case == "revisit":
        m = CFG.line_k                  # the candidate's own cell
        links[:, m + 1] = links[:, m]
        assert bool((has_run[:, m] & (links[:, m] >= 0)).any())
    elif case == "capped":
        drop = torch.from_numpy(rng.random(links.shape) < 0.5).to(g.device)
        links = torch.where(drop, -1, links)
    elif case == "long_run":
        bslot, bpts = _long_runs(g, links, rng)
    elif case in ("narrow", "wide"):
        cfg = dataclasses.replace(CFG, line_k=1 if case == "narrow" else 17)
        cols = (np.arange(2, 5) if case == "narrow"
                else rng.integers(0, CFG.n_line, cfg.n_line))
        links = links[:, torch.from_numpy(cols).to(g.device)].contiguous()
    elif case == "no_candidates":
        cand, nvec, links = cand[:0], nvec[:, :0], links[:0]
    elif case == "no_buffer":
        bslot, bpts = bslot[:0], bpts[:, :0]
    elif case == "offset":
        # a shard's points and centers are global: shift both
        offset = (3, -2, 1)
        bpts = (bpts + torch.tensor(offset, device=bpts.device)[:, None]
                * CFG.resolution[0]).contiguous()
    elif case == "stale_table":
        table = torch.full((g.key.numel(), 2), -1, dtype=torch.int32,
                           device=g.device)
        refine.run_table(_long_runs(g, links, rng)[0], table)
        assert int((table[links[links >= 0].long()] >= 0).sum()) > 0
    elif case == "garbage_table":
        bc = bslot.numel()
        table = torch.randint(-50, 2 * bc + 50, (g.key.numel(), 2),
                              dtype=torch.int32, device=g.device)
    n0 = kernels.LAUNCHES["buffer_replay"]
    gk, gp = _replay_both(g, links, cand, nvec, bslot, bpts, cfg, offset,
                          table)
    launched = cand.numel() > 0 and bslot.numel() > 0
    assert kernels.LAUNCHES["buffer_replay"] == n0 + launched
    assert _same_bits(gk.cyl_stats, gp.cyl_stats)
    ok, err = checks.cyl_stats_error(gk.cyl_stats.cpu().numpy(),
                                     gp.cyl_stats.cpu().numpy(),
                                     CFG.cylinder_radius)
    assert ok, err
    if case in ("ghost", "no_candidates", "no_buffer"):
        assert _same_bits(gk.cyl_stats, g.cyl_stats)
    else:
        assert _hits(gk, g) > 0
    if case == "wide":
        assert links.shape == (U, 35)


def _b3_lanes(dev, grid, runs, n_invalid, K, seed):
    """Synthetic sorted lanes for B3: ``runs`` lanes of each of len(runs)
    distinct cells in ascending id order (about half of them cells the
    grid holds), then ``n_invalid`` INVALID_ID lanes (more, so that K
    divides the lanes); a random lane order, world points, integer colour
    and poses.  Returns (sid, order, world, rgb, poses, N)."""
    rng = np.random.default_rng(seed)
    held = grid.key[grid.key >= 0].cpu().numpy()
    n_cells = int(np.prod(CFG.dims))
    ids = np.union1d(rng.choice(held, len(runs) // 2, replace=False),
                     rng.choice(n_cells, len(runs), replace=False))
    ids = np.sort(rng.choice(ids, len(runs), replace=False))
    n_valid = int(sum(runs))
    M = n_valid + n_invalid
    M += -M % K
    sid = np.full(M, hashing.INVALID_ID, np.int32)
    sid[:n_valid] = np.repeat(ids, runs)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (put(sid), put(rng.permutation(M).astype(np.int64)),
            put(rng.uniform(-0.3, 0.3, (3, M)).astype(np.float32)),
            put(rng.integers(0, 256, (3, M)).astype(np.float32)),
            put(rng.normal(size=(K, 4, 4)).astype(np.float32)), M // K)


B3_CASES = ("one_run", "tile_ends", "ragged_budget", "na0", "k1",
            "buffer_full", "no_color")


@pytest.mark.parametrize("case", B3_CASES)
def test_integrate_lanes_edge_shapes(state, case):
    """B3 against its plain version on synthetic sorted lanes: one cell
    holding every lane (a run across every tile), runs ending exactly on
    tile boundaries, a budget NA that binds and is no multiple of the tile,
    NA = 0, K = 1, a buffer that does not fit, no colour.  The tiles are
    pass B's; pass A's are a multiple of them."""
    pipe, grid, rays, b = state
    T = kernels.B3_TILE
    assert kernels.RUN_SCAN_TILE % T == 0
    rng = np.random.default_rng(B3_CASES.index(case))
    cfg = (dataclasses.replace(CFG, store_color=False) if case == "no_color"
           else CFG)
    K, n_invalid = (1 if case == "k1" else 4), 37
    if case == "one_run":
        runs = [3 * kernels.RUN_SCAN_TILE + 5]
    elif case == "tile_ends":
        runs, n_invalid = [T] * 3 + [T - 1, 1, 2 * T] + [1] * T + [T], 0
    else:
        runs = list(rng.integers(1, 40, 300))
    sid, order, world, rgb, poses, N = _b3_lanes(pipe.device, grid, runs,
                                                 n_invalid, K,
                                                 seed=len(case))
    n_valid, M = int(sum(runs)), sid.numel()
    NA = {"ragged_budget": n_valid - 123, "na0": 0}.get(case, M)
    assert case != "ragged_budget" or NA % T != 0
    gk, gp = _grid_copy(grid), _grid_copy(grid)
    if case == "buffer_full":
        for g in (gk, gp):
            g.buf_count.fill_(cfg.buffer_capacity - NA + 1)
    n0 = kernels.LAUNCHES["integrate_lanes"]
    pk, sk = integrate.aggregate_lanes(gk, sid, order, world, rgb, poses, N,
                                       NA, cfg, extra_dropped=3)
    pp, sp = integrate.aggregate_lanes_plain(gp, sid, order, world, rgb,
                                             poses, N, NA, cfg, 3)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["integrate_lanes"] == n0 + 1
    assert _same_words(pk, pp)
    assert torch.equal(_cells(gk, sk), _cells(gp, sp))
    problems = checks.grid_problems(convert.grid_to_numpy(gk),
                                    convert.grid_to_numpy(gp), cfg)
    assert not problems, problems
    added = int(gk.overflow_active) - int(grid.overflow_active)
    assert added == max(n_valid - NA, 0) + 3
    n_in = float((gk.n_pts - grid.n_pts).sum())
    assert n_in == min(n_valid, NA)
    if case == "buffer_full":
        assert int(gk.overflow_buf) > int(grid.overflow_buf)
    elif case != "na0":
        assert int(gk.buf_count) > int(grid.buf_count)


def _by_cell_words(g):
    """``checks.by_cell`` of a grid with every float array as its 32-bit
    words, so that equal means bit-identical."""
    out = checks.by_cell(convert.grid_to_numpy(g), CFG)
    return {k: v.view(np.int32) if isinstance(v, np.ndarray)
            and v.dtype == np.float32 else v for k, v in out.items()}


def test_integrate_lanes_repeat_bit_identical(state):
    """Two B3 calls on copies of one grid with the same sorted lanes give
    bit-identical grids by cell id (the look-back may combine the tiles'
    sums in another grouping; integer-valued sums are exact in any) and
    the same buffer in order."""
    pipe, grid, rays, b = state
    world, ids, rgb = integrate.depth_frontend(*b, rays, CFG)
    sid, order = torch.sort(ids, stable=True)
    M = ids.numel()
    NA = min(4 * CFG.max_active_points, M)
    got = []
    for _ in range(2):
        g = _grid_copy(grid)
        integrate.aggregate_lanes(g, sid, order, world, rgb, b[3], M // 4,
                                  NA, CFG)
        got.append(g)
    torch.cuda.synchronize()
    a, c = (_by_cell_words(g) for g in got)
    assert a.keys() == c.keys()
    for k in a:
        assert np.array_equal(a[k], c[k]), k
    oa, oc = (checks.ordered_rows(convert.grid_to_numpy(g), CFG)
              for g in got)
    assert np.array_equal(oa["buffer"].view(np.int64),
                          oc["buffer"].view(np.int64))


B6_CASES = ("one_cell", "cap", "ungated", "u1")


@pytest.mark.parametrize("case", B6_CASES)
def test_refine_lines_edge_shapes(state, case):
    """B6 against its plain version on synthetic candidates: lines of more
    candidates than a run-scan tile has lanes converging on one cell (each
    occupied cell four times, their normals scaled so that step k lands on
    its center), every list filled to D - 1 so that D binds, every
    candidate ungated, one candidate.  The grid by cell id with the
    dependant lists in order, and the owner-major links by cell: which
    (candidate, step) wrote a link, and so which owners won where D
    binds."""
    pipe, grid, rays, b = state
    dev = pipe.device
    occ = torch.nonzero(grid.n_pts > 0).squeeze(1).to(torch.int32)
    rng = np.random.default_rng(B6_CASES.index(case))
    cand = {"u1": occ[:1], "one_cell": occ.repeat(4)}.get(case, occ)
    U = cand.numel()
    centers = geometry.center_of_ids(grid.key[cand.long()], CFG)
    if case == "one_cell":
        step = np.float32(CFG.line_k * CFG.resolution[0])
        nvec = ((centers[:, :1] - centers)
                / torch.tensor(step, device=dev)).contiguous()
        assert U > kernels.RUN_SCAN_TILE
    else:
        n = rng.normal(size=(3, U))
        nvec = torch.from_numpy((n / np.linalg.norm(n, axis=0)).astype(
            np.float32)).to(dev)
    gated = torch.full((U,), case != "ungated", dtype=torch.bool,
                       device=dev)
    g0 = _grid_copy(grid)
    D = CFG.max_dependants
    if case == "cap":
        g0.dep_count.copy_(torch.where(g0.key >= 0,
                                       g0.dep_count.clamp(min=D - 1),
                                       g0.dep_count))
    gk, gp = _grid_copy(g0), _grid_copy(g0)
    n0 = kernels.LAUNCHES["refine_lines"]
    lk = refine.refine_lines(cand, nvec, gated, gk, CFG)
    lp = refine.refine_lines_plain(cand, nvec, gated, gp, CFG)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["refine_lines"] == n0 + 1
    problems = checks.grid_problems(convert.grid_to_numpy(gk),
                                    convert.grid_to_numpy(gp), CFG)
    assert not problems, problems
    assert torch.equal(_cells(gk, lk), _cells(gp, lp))
    n_links = int((lk >= 0).sum())
    lids, valid = refine.line_cells(cand, nvec, gated, g0, CFG)
    if case == "ungated":
        assert n_links == 0 and not bool(valid.any())
    else:
        assert n_links > 0
    if case == "one_cell":
        longest = int(torch.unique(lids[valid], return_counts=True)[1].max())
        assert longest > kernels.RUN_SCAN_TILE
    if case in ("one_cell", "cap"):
        assert int(gk.overflow_dep) > int(g0.overflow_dep)


def test_integrate_reads_nothing_and_refine_reads_once(state):
    """On the card an integrate dispatch enqueues everything without a
    synchronizing call, and a refine makes exactly one (its count read)."""
    import warnings
    pipe, grid, rays, b = state
    g = _grid_copy(grid)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe.step_batch_depth(g, *b, rays)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            pipe.refine(g)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    assert int(g.normal_found.sum()) > int(grid.normal_found.sum())


# T4 (tsdf.tsdf_reduce): (cells, lanes M, valid lanes (-1: 3/4 M), extra
# lanes of the first cell's run, budget U), each reduced into a grid that
# holds a first batch of 500 cells
T4_TILE = kernels.RUN_SCAN_TILE
# the id range of ``checks.tsdf_reduce_case``'s lanes, which T5 sorts
T4_IDS = 1 << 20
T4_CASES = {
    "under_u": (700, 12288, -1, 0, 1000),
    "u_plus_one": (1001, 12288, -1, 0, 1000),
    "well_over_u": (4000, 12288, -1, 0, 1000),
    "empty": (0, 12288, 0, 0, 1000),
    "one_run": (1, 12288, 12288, 0, 1000),
    "run_across_tiles": (3000, 5 * T4_TILE + 777, -1, 2 * T4_TILE + 5,
                         4000),
    "u_equals_m": (750, 1000, -1, 0, 1000),
    "many_tiles": (40000, 100 * T4_TILE + 3, -1, 0, 20000),
    # runs of a few lanes straddling every ladder block's edge
    "block_edges": (3000, 12288, -1, 0, 4000),
    # a run of over 1024 lanes over three ladder blocks, the middle one
    # without a run start; one of ~78 blocks (the carry's tree over 64
    # block summaries); one over every lane of 100 tiles
    "run_over_three_blocks": (300, 12288, -1, 2000, 1000),
    "run_over_78_blocks": (200, 65536, -1, 40000, 4000),
    "one_run_many_tiles": (1, 100 * T4_TILE + 3, 100 * T4_TILE + 3, 0,
                           1000),
    # M <= 1024: the flat ladder, under and over U, and M = 1025
    "flat_over_u": (700, 1000, -1, 0, 300),
    "flat_one_lane": (1, 1, 1, 0, 1),
    "flat_edge": (600, 1024, -1, 0, 1000),
    "blocked_edge": (600, 1025, -1, 0, 1000),
}


def _t4_inputs(dev, case):
    n_cells, M, n_valid, run, U = T4_CASES[case]
    skey, vals6 = (torch.from_numpy(a).to(dev) for a in
                   checks.tsdf_reduce_case(n_cells, M, seed=2,
                                           n_valid=n_valid, run_lanes=run))
    first = checks.tsdf_reduce_case(500, 12288, seed=1)
    grid = tsdf.make_tsdf_grid(TCFG, dev)
    skey1, vals1 = (torch.from_numpy(a).to(dev) for a in first)
    tsdf.tsdf_reduce(grid, *tsdf.sort_lanes(skey1, T4_IDS), vals1, 1000,
                     TCFG)
    return grid, skey, vals6, U


def _t4_reduce(fn, grid, skey, vals6, U, cfg):
    fn(grid, *tsdf.sort_lanes(skey, T4_IDS), vals6, U, cfg)
    torch.cuda.synchronize()
    return checks.tsdf_by_cell(convert.tsdf_grid_to_numpy(grid, cfg),
                               cfg.base.capacity)


@pytest.mark.parametrize("case", list(T4_CASES))
def test_tsdf_reduce_matches_plain(dev, case):
    """T4 with K2 against its plain version on the same lanes: the cell
    set, both counters exactly and ``vstats`` bit for bit by cell."""
    grid, skey, vals6, U = _t4_inputs(dev, case)
    gk, gp = _grid_copy(grid), _grid_copy(grid)
    n0 = kernels.LAUNCHES["tsdf_reduce"]
    a = _t4_reduce(tsdf.tsdf_reduce, gk, skey, vals6, U, TCFG)
    assert kernels.LAUNCHES["tsdf_reduce"] == n0 + 1
    b = _t4_reduce(tsdf.tsdf_reduce_plain, gp, skey, vals6, U, TCFG)
    assert np.array_equal(a["cell"], b["cell"])
    assert a["vstats"].tobytes() == b["vstats"].tobytes()
    for k in ("overflow_unique", "overflow_probe"):
        assert a[k] == b[k], k
    assert a["overflow_unique"] == max(T4_CASES[case][0] - U, 0)
    assert a["overflow_probe"] == 0


@pytest.mark.parametrize("case", ["block_edges", "run_over_78_blocks",
                                  "many_tiles", "flat_over_u"])
def test_tsdf_reduce_repeat_bit_identical(dev, case):
    """Two launches of T4 on copies of one grid leave the same cells with
    the same ``vstats`` words by cell (K2's CAS race may seat a cell in
    another slot): no atomics decide a sum."""
    grid, skey, vals6, U = _t4_inputs(dev, case)
    ga, gb = _grid_copy(grid), _grid_copy(grid)
    sid, order = tsdf.sort_lanes(skey, T4_IDS)
    for g in (ga, gb):
        tsdf.tsdf_reduce(g, sid, order, vals6, U, TCFG)
    torch.cuda.synchronize()
    a, b = (checks.tsdf_by_cell(convert.tsdf_grid_to_numpy(g, TCFG),
                                TCFG.base.capacity) for g in (ga, gb))
    assert np.array_equal(a["cell"], b["cell"])
    assert a["vstats"].tobytes() == b["vstats"].tobytes()
    for k in ("overflow_unique", "overflow_probe"):
        assert a[k] == b[k], k


def test_tsdf_reduce_probe_overflow(dev):
    """A 256-slot table with 4 probes: K2's CAS race may place other ids
    than the plain version's election, so each placed cell's sums are held
    to the plain reduce into a table that fits them all, bit for bit, and
    every kept id is either placed or counted in ``overflow_probe``."""
    U = 1000
    skey, vals6 = (torch.from_numpy(a).to(dev) for a in
                   checks.tsdf_reduce_case(600, 12288, seed=3))
    tiny = dataclasses.replace(TCFG, base=dataclasses.replace(
        TCFG.base, capacity_log2=8, max_probes=4))
    a = _t4_reduce(tsdf.tsdf_reduce, tsdf.make_tsdf_grid(tiny, dev), skey,
                   vals6, U, tiny)
    ref = _t4_reduce(tsdf.tsdf_reduce_plain, tsdf.make_tsdf_grid(TCFG, dev),
                     skey, vals6, U, TCFG)
    assert a["overflow_probe"] > 0 and a["overflow_unique"] == 0
    assert a["cell"].size + a["overflow_probe"] == ref["cell"].size == 600
    rows = np.searchsorted(ref["cell"], a["cell"])
    assert np.array_equal(ref["cell"][rows], a["cell"])
    assert a["vstats"].tobytes() == ref["vstats"][rows].tobytes()


def test_tsdf_reduce_reads_nothing(dev):
    """A TSDF batch on the card, T4 alone and a whole depth dispatch,
    enqueues everything without a synchronizing call."""
    skey, vals6 = (torch.from_numpy(a).to(dev) for a in
                   checks.tsdf_reduce_case(4000, 12288, seed=4))
    pipe = tsdf.TsdfPipeline(TCFG, dev)
    rays = pipe.put(RAYS)
    grid = pipe.init()
    b = _batch(pipe, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tsdf.tsdf_reduce(grid, *tsdf.sort_lanes(skey, T4_IDS), vals6, 1000,
                         TCFG)
        pipe.step_batch_depth(grid, *b, rays)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(grid.overflow_unique) >= 3000 and int(grid.frames) == 4
