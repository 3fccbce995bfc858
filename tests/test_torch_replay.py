"""The refine's links and buffer replay in the port's plain versions (what
the CPU runs, and what kernels B6 and B7 are held to on the card).

* ``refine_lines_plain``'s owner-major links: every written link sits at
  its step's line cell, the (slot, candidate) pairs are exactly the
  dependants the pass appended, and the valid lanes without a link are
  the ones counted in ``overflow_dep``; at ``line_k`` 3 and 1;
* the runs table (``run_table``, ``run_lookup``): each slot's run in the
  slot-sorted buffer, its first lane and length as ``torch.searchsorted``
  finds them, from a table full of garbage, stale entries and
  out-of-range values;
* ``buffer_replay_plain`` against a straightforward replay (every
  (link, point) pair through ``integrate.cylinder_add``): hits exact,
  sums within ``checks.cyl_stats_error``, on B6's links and on edge
  shapes (ghost cells, a line visiting one cell twice, capped links,
  runs of up to 1000 points, L = 3 and L = 35, no candidates, no buffer,
  a shard's offset, a runs table holding another buffer's runs);
* ``buffer_replay_plain``'s sums bit for bit against the kernel's order
  written out as loops over float32 scalars (a candidate's pairs
  numbered in step order, lane p % G of its group summing pair p, then a
  pairwise tree over the group), at L = 7 (groups of 8) and L = 35
  (groups of 32).
"""

import dataclasses

import numpy as np
import pytest
import torch

from hifi_fusion_tpu_torch import checks
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.models.pipeline import FusionPipeline
from hifi_fusion_tpu_torch.ops import geometry, integrate, refine
from hifi_fusion_tpu_torch.utils.synthetic import camera_rays, make_depth_sweep

CFG = small_test_config(refine_every=4, max_batch_frames=4,
                        z_clip=(0.05, 10.0))
W = H = 64
RAYS = camera_rays(W, H, fx=80.0, fy=80.0)
FRAMES = make_depth_sweep(CFG, 8, width=W, height=H, srays=RAYS, seed=5,
                          noise_sd=3e-4, camera_height=0.4)


def _copy(g):
    return dataclasses.replace(g, **{f.name: getattr(g, f.name).clone()
                                     for f in dataclasses.fields(g)})


@pytest.fixture(scope="module")
def state():
    """A CPU grid after a batch, a refine and a second batch: candidates,
    dependants and a buffer to replay."""
    pipe = FusionPipeline(CFG, "cpu")
    rays = pipe.put(RAYS)
    grid = pipe.init()
    for i in range(2):
        fs = FRAMES[4 * i:4 * i + 4]
        pipe.step_batch_depth(
            grid, pipe.put(np.stack([f.depth_q for f in fs])),
            pipe.put(np.stack([f.rgb565 for f in fs])),
            pipe.put(np.full((4,), W * H, np.int32)),
            pipe.put(np.stack([f.pose for f in fs])), rays)
        if i == 0:
            pipe.refine(grid)
    return grid


def _fit(grid, cfg=CFG):
    cand = torch.nonzero((grid.n_pts > 0) & ~grid.normal_found).squeeze(
        1).to(torch.int32)
    nvec, gated = refine.normal_fit_plain(cand, grid, cfg)
    return cand, nvec, gated


@pytest.mark.parametrize("line_k", [3, 1])
def test_refine_lines_owner_major_links(state, line_k):
    cfg = dataclasses.replace(CFG, line_k=line_k)
    g = _copy(state)
    cand, nvec, gated = _fit(g, cfg)
    U, L, D = cand.numel(), cfg.n_line, cfg.max_dependants
    count0, dep0 = g.dep_count.clone(), g.dep.clone()
    over0, probe0 = int(g.overflow_dep), int(g.overflow_probe)
    links = refine.refine_lines_plain(cand, nvec, gated, g, cfg)
    assert links.shape == (U, L) and links.dtype == torch.int32
    lids, valid = refine.line_cells(cand, nvec, gated, state, cfg)
    cell, valid = lids.view(L, U).t(), valid.view(L, U).t()
    w = links >= 0
    assert int(w.sum()) > 0
    # step: each written link holds its own step's line cell
    assert bool(valid[w].all())
    assert torch.equal(g.key[links[w].long()], cell[w])
    # (slot, candidate): the links are the dependants the pass appended
    owner = cand[:, None].expand(U, L)
    got = sorted(zip(links[w].tolist(), owner[w].tolist()))
    old = torch.arange(D)[None] < count0.clamp(max=D)[:, None]
    assert torch.equal(dep0.view(-1, D)[old], g.dep.view(-1, D)[old])
    appended = []
    for s in torch.nonzero(g.dep_count != count0).squeeze(1).tolist():
        for k in range(int(count0[s]), min(int(g.dep_count[s]), D)):
            appended.append((s, int(g.dep[s * D + k])))
    assert got == sorted(appended)
    # the valid lanes without a link are the ones D turned away
    assert int(g.overflow_probe) == probe0
    assert int(g.overflow_dep) - over0 == int((valid & ~w).sum())


def _sorted_slots(rng, C, n_runs, longest):
    slots = np.sort(rng.choice(C, n_runs, replace=False))
    return torch.from_numpy(np.repeat(slots, rng.integers(
        1, longest + 1, n_runs)).astype(np.int32))


LOOKUP_CASES = ("garbage", "stale", "one_run", "empty")


@pytest.mark.parametrize("case", LOOKUP_CASES)
def test_run_start_lookup_vs_searchsorted(case):
    rng = np.random.default_rng(LOOKUP_CASES.index(case))
    C = 1000
    bslot = {"one_run": torch.full((500,), 7, dtype=torch.int32),
             "empty": torch.zeros((0,), dtype=torch.int32)}.get(
        case, _sorted_slots(rng, C, 80, 9))
    bc = bslot.numel()
    # garbage: negative, past the buffer and inside it at random
    table = torch.from_numpy(rng.integers(-50, 2 * bc + 50, (C, 2)).astype(
        np.int32))
    if case == "stale":
        # the table of an earlier buffer, then garbage where it left none
        refine.run_table(_sorted_slots(rng, C, 300, 30), table)
    refine.run_table(bslot, table)
    q = torch.arange(C, dtype=torch.int32)
    first = torch.searchsorted(bslot, q).to(torch.int32)
    cnt = torch.searchsorted(bslot, q, right=True).to(torch.int32) - first
    start, n = refine.run_lookup(table, bslot, q)
    assert torch.equal(n, cnt)
    assert torch.equal(torch.where(cnt > 0, start, 0),
                       torch.where(cnt > 0, first, 0))
    assert int((n > 0).sum()) == torch.unique(bslot).numel()


def _reference(links, cand, nvec, bslot, bpts, grid, cfg, offset=None):
    """Every written link's run by ``searchsorted`` and every (link,
    point) pair through ``integrate.cylinder_add``, in pair order."""
    U, L = links.shape
    s = links.reshape(-1)
    u = torch.arange(U).repeat_interleave(L)
    w = s >= 0
    s, u = s[w], u[w]
    first = torch.searchsorted(bslot, s)
    cnt = torch.searchsorted(bslot, s, right=True) - first
    link = torch.repeat_interleave(torch.arange(s.numel()), cnt)
    within = torch.arange(link.numel()) - (torch.cumsum(cnt, 0) - cnt)[link]
    uu = u[link]
    center = geometry.center_of_ids(grid.key[cand.long()], cfg, offset)
    integrate.cylinder_add(grid.cyl_stats, cand[uu].long(),
                           bpts[:, first[link] + within], center[:, uu],
                           nvec[:, uu], cfg.cylinder_radius)


def _replay_inputs(state):
    g = _copy(state)
    cand, nvec, gated = _fit(g)
    links = refine.refine_lines_plain(cand, nvec, gated, g, CFG)
    bslot, bpts = refine.sorted_buffer(g, int(g.buf_count))
    return g, cand, nvec, links, bslot, bpts


def _long_runs(g, links, rng, lens=(1, 2, 7, 8, 9, 31, 32, 33, 100, 1000)):
    """A slot-sorted buffer of runs of ``lens`` points in the line cells
    of the first written links, spread over each cell."""
    slots = torch.unique(links[links >= 0])[:40]
    bslot = torch.repeat_interleave(slots, torch.from_numpy(
        np.resize(lens, slots.numel())))
    center = geometry.center_of_ids(g.key[bslot.long()], CFG)
    half = CFG.resolution[0] / 2
    noise = rng.uniform(-half, half, (3, bslot.numel())).astype(np.float32)
    return bslot, (center + torch.from_numpy(noise)).contiguous()


def _edge_case(case, g, cand, nvec, links, bslot, bpts, rng):
    """The inputs of one edge case: (links, cand, nvec, bslot, bpts, cfg,
    offset, table)."""
    cfg, offset, table = CFG, None, None
    has_run = torch.isin(links, bslot)
    if case == "ghost":
        links = torch.where(has_run, -1, links)
        assert bool((links >= 0).any())
    elif case == "revisit":
        m = CFG.line_k                  # the candidate's own cell
        links[:, m + 1] = links[:, m]
        assert bool((has_run[:, m] & (links[:, m] >= 0)).any())
    elif case == "capped":
        links = torch.where(torch.from_numpy(rng.random(links.shape) < 0.5),
                            -1, links)
    elif case == "long_run":
        bslot, bpts = _long_runs(g, links, rng)
    elif case in ("narrow", "wide"):
        cfg = dataclasses.replace(CFG, line_k=1 if case == "narrow" else 17)
        cols = (np.arange(2, 5) if case == "narrow"
                else rng.integers(0, CFG.n_line, cfg.n_line))
        links = links[:, torch.from_numpy(cols)].contiguous()
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
        table = torch.full((g.key.numel(), 2), -1, dtype=torch.int32)
        refine.run_table(_long_runs(g, links, rng)[0], table)
    return links, cand, nvec, bslot, bpts, cfg, offset, table


REPLAY_CASES = ("main", "ghost", "revisit", "capped", "long_run", "narrow",
                "wide", "no_candidates", "no_buffer", "offset",
                "stale_table")


@pytest.mark.parametrize("case", REPLAY_CASES)
def test_buffer_replay_plain_vs_reference(state, case):
    g, *inputs = _replay_inputs(state)
    rng = np.random.default_rng(REPLAY_CASES.index(case))
    links, cand, nvec, bslot, bpts, cfg, offset, table = _edge_case(
        case, g, *inputs, rng)
    got, want = _copy(g), _copy(g)
    refine.buffer_replay(links, cand, nvec, bslot, bpts, got, cfg, offset,
                         table)
    _reference(links, cand, nvec, bslot, bpts, want, cfg, offset)
    ok, err = checks.cyl_stats_error(got.cyl_stats.numpy(),
                                     want.cyl_stats.numpy(),
                                     cfg.cylinder_radius)
    assert ok, err
    hits = float((got.cyl_stats.view(-1, 5)[:, 4]
                  - g.cyl_stats.view(-1, 5)[:, 4]).sum())
    if case in ("ghost", "no_candidates", "no_buffer"):
        assert torch.equal(got.cyl_stats, g.cyl_stats)
    else:
        assert hits > 0


def _kernel_order(links, cand, nvec, bslot, bpts, grid, cfg):
    """Kernel B7's arithmetic as loops over float32 scalars: candidate
    u's (link, point) pairs numbered p = 0, 1, ... over its links' runs
    in step order, lane p % G of its group adding pair p's hit; a
    pairwise tree over the lanes; the owner's row plus the totals where
    it had a hit."""
    U, L = links.shape
    G = refine.replay_group(L)
    f32 = np.float32
    center = geometry.center_of_ids(grid.key[cand.long()], cfg).numpy()
    nv, pts = nvec.numpy(), bpts.numpy()
    bs, ln = bslot.numpy(), links.numpy()
    cs = grid.cyl_stats.view(-1, 5).numpy()
    radius = f32(cfg.cylinder_radius)
    for u in range(U):
        acc = np.zeros((G, 5), f32)
        p = 0
        for step in range(L):
            s = ln[u, step]
            if s < 0:
                continue
            a, b = np.searchsorted(bs, s), np.searchsorted(bs, s, "right")
            for w in range(b - a):
                q = [f32(pts[x, a + w]) - f32(center[x, u]) for x in range(3)]
                t = (q[0] * nv[0, u] + q[1] * nv[1, u]) + q[2] * nv[2, u]
                r = [q[x] - t * nv[x, u] for x in range(3)]
                d = np.sqrt((r[0] * r[0] + r[1] * r[1]) + r[2] * r[2])
                if d < radius:
                    acc[p % G] += np.array([t, t * t, d, d * d, 1], f32)
                p += 1
        while acc.shape[0] > 1:
            acc = acc[0::2] + acc[1::2]
        if acc[0, 4] > 0:
            cs[int(cand[u])] += acc[0]


@pytest.mark.parametrize("line_k", [3, 17])
def test_buffer_replay_plain_sums_in_kernel_order(state, line_k):
    g, cand, nvec, links, bslot, bpts = _replay_inputs(state)
    rng = np.random.default_rng(line_k)
    bslot, bpts = _long_runs(g, links, rng, lens=(1, 5, 9, 40, 120))
    take = torch.nonzero(torch.isin(links, bslot).any(1)).squeeze(1)[:24]
    cand, nvec, links = cand[take], nvec[:, take].contiguous(), links[take]
    cfg = dataclasses.replace(CFG, line_k=line_k)
    links = links[:, torch.from_numpy(rng.integers(
        0, CFG.n_line, cfg.n_line))].contiguous()
    got, want = _copy(g), _copy(g)
    refine.buffer_replay(links, cand, nvec, bslot, bpts, got, cfg)
    _kernel_order(links, cand, nvec, bslot, bpts, want, cfg)
    assert torch.equal(got.cyl_stats.view(torch.int32),
                       want.cyl_stats.view(torch.int32))
    assert float((got.cyl_stats.view(-1, 5)[:, 4]
                  - g.cyl_stats.view(-1, 5)[:, 4]).sum()) > 0
