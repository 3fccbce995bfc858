"""The neighbourhood queries of the port (ops/queries.py; the plain version
of kernel B11 on the CPU) against the JAX package's ``ops/queries.py``, on
the same fused frames (``make_sweep``, ``small_test_config()``, one
``step`` a frame and a final refine in each package).

Slots differ between the packages, so every slot-valued result is mapped
through the grid's key: counts per queried cell, the ROR mask as the set
of kept cells, ``PointQuery.slot`` as the cell it holds.  Integers must
match exactly.  Also: a brute-force count, an isolated voxel removed, and
the bitmap form that kernel B11 reads against the lookup form, on that
grid and on a tiny table whose inserts overflowed (``overflow_probe >
0``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifi_fusion_tpu import grid as jgrid
from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.models import pipeline as jpipe
from hifi_fusion_tpu.ops import queries as jq
from hifi_fusion_tpu.ops.refine import refine_pass as jax_refine
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.grid import count_at, occupied_at
from hifi_fusion_tpu_torch.models.pipeline import FusionPipeline
from hifi_fusion_tpu_torch.ops import geometry, hashing, queries
from hifi_fusion_tpu_torch.utils.synthetic import make_sweep, pad_frame

KW = dict(refine_every=2, max_batch_frames=2)
CFG = small_test_config(**KW)
JCFG = jax_config(**KW)
C = CFG.capacity
FRAMES = [pad_frame(f, CFG.max_points)
          for f in make_sweep(CFG, 4, 900, seed=2)]


def _port_grid(cfg, frames):
    pipe = FusionPipeline(cfg, "cpu")
    g = pipe.init()
    for f in frames:
        pipe.step(g, *(torch.from_numpy(a) for a in (
            f.points_cam, f.rgb, f.mask, f.pose)))
    return pipe.refine(g)


@pytest.fixture(scope="module")
def grids():
    g = _port_grid(CFG, FRAMES)
    jg = jgrid.make_grid(JCFG)
    for f in FRAMES:
        jg = jpipe.fusion_step(jg, *(jnp.asarray(a) for a in (
            f.points_cam, f.rgb, f.mask, f.pose)),
            config=JCFG)
    return g, jax_refine(jg, config=JCFG)


def _slots_of(key, cells):
    """The slot of each cell id in a key table (-1 where absent)."""
    key = np.asarray(key)[:C]
    order = np.argsort(key)
    pos = np.searchsorted(key[order], cells)
    pos = np.clip(pos, 0, C - 1)
    hit = key[order][pos] == cells
    return np.where(hit, order[pos], -1).astype(np.int32)


def _occupied_cells(g):
    key = g.key.numpy()
    return np.sort(key[(g.n_pts > 0).numpy()])


def test_fused_grids_hold_the_same_cells(grids):
    g, jg = grids
    jocc = np.asarray(jgrid.occupied_slots(jg, C))
    cells = _occupied_cells(g)
    np.testing.assert_array_equal(
        cells, np.sort(np.asarray(jg.key)[:C][jocc]))
    assert cells.size > 300 and int(g.normal_found.sum()) > 0


@pytest.mark.parametrize("r", [1, 2, 3])
def test_neighbor_counts_match_jax(grids, r):
    """Every occupied cell, a ghost line cell when there is one, and -1
    queries, by cell id."""
    g, jg = grids
    key = g.key.numpy()
    ghosts = np.sort(key[(key >= 0) & (g.n_pts.numpy() == 0)])[:20]
    cells = np.concatenate([_occupied_cells(g), ghosts])
    ps = np.concatenate([_slots_of(key, cells), [-1, -1]]).astype(np.int32)
    js = np.concatenate([_slots_of(jg.key, cells), [-1, -1]]).astype(
        np.int32)
    assert (ps[:-2] >= 0).all() and (js[:-2] >= 0).all()
    got = queries.occupied_neighbor_counts(g, torch.from_numpy(ps), CFG,
                                           radius_cells=r).numpy()
    want = np.asarray(jq.occupied_neighbor_counts(
        jg, jnp.asarray(js), config=JCFG, radius_cells=r))
    np.testing.assert_array_equal(got, want)
    assert got[-2:].tolist() == [0, 0] and got[:-2].min() >= 0
    assert got.max() > 1


@pytest.mark.parametrize("r,min_nb", [(2, 5), (1, 4), (2, 12)])
def test_radius_outlier_mask_matches_jax(grids, r, min_nb):
    g, jg = grids
    keep = queries.radius_outlier_mask(g, CFG, radius_cells=r,
                                       min_neighbors=min_nb).numpy()
    jkeep = np.asarray(jq.radius_outlier_mask(
        jg, config=JCFG, radius_cells=r, min_neighbors=min_nb))
    assert keep.shape == (C,) and keep.dtype == np.bool_
    np.testing.assert_array_equal(np.sort(g.key.numpy()[keep]),
                                  np.sort(np.asarray(jg.key)[:C][jkeep]))
    assert 0 < keep.sum() <= (g.n_pts > 0).sum()


def test_query_points_match_jax(grids):
    """Occupied cell centers, random points across the bbox (empty cells,
    ghosts), and points outside it."""
    g, jg = grids
    rng = np.random.default_rng(11)
    cells = torch.from_numpy(_occupied_cells(g)[::3].copy())
    centers = geometry.center_of_ids(cells, CFG).numpy()
    b = CFG.bbox
    rand = rng.uniform([b[0], b[2], b[4]], [b[1], b[3], b[5]],
                       (2000, 3)).T.astype(np.float32)
    out = np.asarray([[10.0, -0.5, 0.0], [0.0, 0.0, 0.0],
                      [0.0, 0.0, 0.4]], np.float32)
    pts = np.concatenate([centers, rand, out], axis=1)
    q = queries.query_points(g, torch.from_numpy(pts), CFG)
    jqr = jq.query_points(jg, jnp.asarray(pts), config=JCFG)

    def cell(key, slot):
        return np.where(slot >= 0, np.asarray(key)[np.maximum(slot, 0)], -1)

    np.testing.assert_array_equal(cell(g.key.numpy(), q.slot.numpy()),
                                  cell(jg.key, np.asarray(jqr.slot)))
    for f in ("occupied", "normal_found", "count"):
        np.testing.assert_array_equal(getattr(q, f).numpy(),
                                      np.asarray(getattr(jqr, f)), err_msg=f)
    n = centers.shape[1]
    assert q.occupied[:n].all() and int(q.count[:n].sum()) > 0
    assert (q.slot[-3:] == -1).all()


def test_occupied_at_and_count_at_match_jax(grids):
    g, jg = grids
    cells = _occupied_cells(g)
    ps = torch.from_numpy(_slots_of(g.key.numpy(), cells))
    js = jnp.asarray(_slots_of(jg.key, cells))
    np.testing.assert_array_equal(occupied_at(g, ps).numpy(),
                                  np.asarray(jgrid.occupied_at(jg, js)))
    np.testing.assert_array_equal(count_at(g, ps).numpy(),
                                  np.asarray(jgrid.count_at(jg, js)))


def test_neighbor_counts_match_brute_force(grids):
    g, _ = grids
    occ = set(_occupied_cells(g).tolist())
    key = g.key.numpy()
    slots = np.flatnonzero((g.n_pts > 0).numpy())[:60].astype(np.int32)
    got = queries.occupied_neighbor_counts(g, torch.from_numpy(slots), CFG,
                                           radius_cells=2).numpy()
    dx, dy, dz = CFG.dims
    for i, s in enumerate(slots):
        cid = int(key[s])
        x, y, z = cid // (dy * dz), (cid // dz) % dy, cid % dz
        brute = sum(
            ((xx * dy + yy) * dz + zz) in occ
            for xx in range(x - 2, x + 3) for yy in range(y - 2, y + 3)
            for zz in range(z - 2, z + 3)
            if 0 <= xx < dx and 0 <= yy < dy and 0 <= zz < dz)
        assert got[i] == brute, (i, s)


def test_radius_outlier_removes_isolated_voxel():
    g = _port_grid(CFG, FRAMES)
    lone = torch.tensor([CFG.dims[2] * CFG.dims[1] * 3 + 7],
                        dtype=torch.int32)
    slot, failed = hashing.lookup_or_insert(g.key, lone, CFG.max_probes, C)
    assert int(failed) == 0
    g.n_pts[slot.long()] = 1.0            # occupied: a point and its bit
    g.occ_bits[lone.long() >> 5] |= (1 << (int(lone) & 31))
    keep = queries.radius_outlier_mask(g, CFG, radius_cells=2,
                                       min_neighbors=4)
    assert not bool(keep[slot.long()])
    assert float(keep.sum()) / float((g.n_pts > 0).sum()) > 0.7


@pytest.mark.parametrize("table", ["sweep", "overflowed"])
def test_bitmap_form_equals_lookup_form(grids, table):
    """The occupancy bitmap holds exactly the cells with a slot and a
    point, so B11's bitmap window counts what the JAX package's lookups
    count, also where inserts overflowed (an unplaced cell has neither a
    slot nor a bit)."""
    if table == "sweep":
        g, cfg = grids[0], CFG
    else:
        cfg = small_test_config(capacity_log2=10, max_probes=4,
                                max_unique_per_frame=1024, **KW)
        g = _port_grid(cfg, FRAMES)
        assert int(g.overflow_probe) > 0
    slots = torch.cat([torch.arange(cfg.capacity, dtype=torch.int32),
                       torch.tensor([-1, -5], dtype=torch.int32)])
    for r in (1, 2):
        a = queries.neighbor_counts_bitmap(g, slots, cfg, r)
        b = queries.neighbor_counts_plain(g, slots, cfg, r)
        assert torch.equal(a, b)
        assert int(b.max()) > 1 and b[-2:].tolist() == [0, 0]


def test_query_argument_checks(grids):
    g, _ = grids
    s = torch.tensor([0, -1], dtype=torch.int32)
    with pytest.raises(ValueError):
        queries.occupied_neighbor_counts(g, s, CFG, radius_cells=16)
    with pytest.raises(ValueError):
        queries.occupied_neighbor_counts(g, s.long(), CFG)
    assert queries.occupied_neighbor_counts(g, s[:0], CFG).shape == (0,)
