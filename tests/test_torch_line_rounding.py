"""The refine's line cells, rounded as the JAX package's jitted program
rounds them.

A line point is ``center + (s * res0) * n``; its floor decides the cell
its candidate is appended to.  XLA contracts that multiply-add into one
fused multiply-add inside ``jit``, so the port's ``refine.line_cells``
(and kernel B6, held to it on the card) computes it fused.  These tests
hold ``line_cells`` to the JAX package's line points under ``jit`` bit for
bit, on unit normals some of which put a line point within a few ulps of
a cell face, where the fused and the separately rounded forms floor
differently; the separately rounded form must differ there, so that the
comparison can tell the two apart.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.ops import geometry as jgeom
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.ops import geometry, refine

CFG = small_test_config()
JCFG = jax_config()
K = CFG.line_k
U = 2_000_000 // CFG.n_line        # ~2e6 line points


@jax.jit
def _jax_lines(ids, nvec, gated):
    """The line points and cells of ``refine_pass_impl``
    (hifi_fusion_tpu/ops/refine.py:172-176 and :263-271), as written
    there, for a single grid."""
    f32 = jnp.float32
    center = jgeom.cell_center(jgeom.id_to_coords(ids, JCFG), JCFG)
    res = jnp.asarray(JCFG.resolution, f32)
    steps = jnp.arange(-K, K + 1, dtype=f32)
    line_pts = (center[:, None, :]
                + steps[None, :, None] * res[0] * nvec[:, None, :])
    lp_valid = jgeom.valid_points(line_pts, JCFG) & gated[None, :]
    lcoords = jgeom.cell_coords(line_pts, JCFG)
    lp_valid = lp_valid & jgeom.valid_coords(lcoords, JCFG)
    return (line_pts, jgeom.cell_id(lcoords, JCFG).reshape(-1),
            lp_valid.reshape(-1))


def _separately_rounded(ids, nvec, gated):
    """``line_cells`` with ``(s * res0) * n`` rounded before the add."""
    center = geometry.center_of_ids(ids, CFG)
    sr = torch.arange(-K, K + 1, dtype=torch.float32) * torch.tensor(
        CFG.resolution[0], dtype=torch.float32)
    line = center[:, None, :] + sr[None, :, None] * nvec[:, None, :]
    lc = geometry.cell_coords(line, CFG)
    valid = (geometry.valid_points(line, CFG) & gated[None, :]
             & geometry.valid_coords(lc, CFG)).reshape(-1)
    return line, geometry.cell_id(lc, CFG).reshape(-1), valid


def _inputs(seed):
    """U candidate cells and unit normals: half drawn at random, half with
    an x component within 8 ulps of 1/2, 1/4 or 1/6, so that step 1, 2 or
    3 puts the line point a few ulps from a cell face."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, int(np.prod(CFG.dims)), U).astype(np.int32)
    n = rng.normal(size=(3, U)).astype(np.float32)
    half = U // 2
    x = rng.choice([0.5, 0.25, 1 / 6], half).astype(np.float32)
    ulps = rng.integers(-8, 9, half, dtype=np.int32)
    x = (x.view(np.int32) + ulps).view(np.float32)
    x *= rng.choice([-1, 1], half).astype(np.float32)
    yz = n[1:, :half] / np.linalg.norm(n[1:, :half], axis=0)
    n[0, :half] = x
    n[1:, :half] = yz * np.sqrt(1 - x.astype(np.float64) ** 2)
    n[:, half:] /= np.linalg.norm(n[:, half:], axis=0)
    gated = rng.random(U) < 0.9
    return ids, n.astype(np.float32), gated


@pytest.mark.parametrize("seed", [0, 1])
def test_line_cells_bit_exact_vs_jax_jit(seed):
    ids, n, gated = _inputs(seed)
    j_pts, j_ids, j_valid = (np.asarray(a) for a in _jax_lines(
        jnp.asarray(ids), jnp.asarray(n), jnp.asarray(gated)))

    t_ids, t_n, t_gated = (torch.from_numpy(a) for a in (ids, n, gated))
    grid = types.SimpleNamespace(key=t_ids)
    got_ids, got_valid = refine.line_cells(
        torch.arange(U, dtype=torch.int32), t_n, t_gated, grid, CFG)
    got_ids, got_valid = got_ids.numpy(), got_valid.numpy()
    np.testing.assert_array_equal(got_valid, j_valid)
    np.testing.assert_array_equal(got_ids[j_valid], j_ids[j_valid])

    # the separately rounded form: other points, and other cells
    s_pts, s_ids, s_valid = (a.numpy() for a in _separately_rounded(
        t_ids, t_n, t_gated))
    live = j_valid & s_valid
    assert (s_pts != j_pts).mean() > 0.01
    assert int((s_ids[live] != j_ids[live]).sum()) > 0
