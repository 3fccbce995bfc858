"""The port's geometry and eigensolver against the JAX package's, on the
same seeded numpy inputs: cell coords, validity, ids, centers and the
sweeps' SE(3) transforms bit-exact (coords and centers as the JAX
package's jitted programs compute them); smallest eigenvectors within 1e-5
of the JAX solver's and of numpy.linalg.eigh (up to sign)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.ops import geometry as jgeo
from hifi_fusion_tpu.ops.eigen33 import smallest_eigenpair_sym as jax_eig
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.ops import geometry
from hifi_fusion_tpu_torch.ops.eigen33 import smallest_eigenpair_sym

CFG = small_test_config()
JCFG = jax_config()
RNG = np.random.default_rng(11)


def _points(n=4096):
    lo = np.asarray(CFG.origin, np.float32)
    span = np.asarray([CFG.bbox[1] - CFG.bbox[0], CFG.bbox[3] - CFG.bbox[2],
                       CFG.bbox[5] - CFG.bbox[4]], np.float32)
    p = lo[:, None] + span[:, None] * (RNG.random((3, n)) * 1.2 - 0.1)
    return p.astype(np.float32)


# the JAX package computes cell coords inside jitted programs, where the
# resolution is a constant and XLA multiplies by its folded reciprocal
_jit_coords = jax.jit(lambda p: jgeo.cell_coords(p, JCFG))


def test_cells_bit_exact():
    p = _points()
    tp, jp = torch.from_numpy(p), jnp.asarray(p)
    tc = geometry.cell_coords(tp, CFG)
    jc = _jit_coords(jp)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(geometry.valid_points(tp, CFG).numpy(),
                                  np.asarray(jgeo.valid_points(jp, JCFG)))
    tv = geometry.valid_coords(tc, CFG).numpy()
    np.testing.assert_array_equal(tv, np.asarray(jgeo.valid_coords(jc, JCFG)))
    assert 0 < tv.sum() < tv.size
    ids = geometry.cell_id(tc, CFG).numpy()
    np.testing.assert_array_equal(ids[tv],
                                  np.asarray(jgeo.cell_id(jc, JCFG))[tv])
    vid = torch.from_numpy(ids[tv])
    np.testing.assert_array_equal(
        geometry.id_to_coords(vid, CFG).numpy(),
        np.asarray(jgeo.id_to_coords(jnp.asarray(ids[tv]), JCFG)))
    # centers as the JAX package's jitted programs compute them: XLA
    # contracts origin + res * (coord + 0.5) into one fused multiply-add
    jit_center = jax.jit(lambda i: jgeo.center_of_ids(i, JCFG))
    np.testing.assert_array_equal(
        geometry.center_of_ids(vid, CFG).numpy(),
        np.asarray(jit_center(jnp.asarray(ids[tv]))))


def test_cell_coords_on_cell_faces_match_jit():
    """Points a few ulps from cell faces, where floor((p - o) / res) and
    floor((p - o) * (1 / res)) differ: the port takes the JAX package's
    jitted (reciprocal) side on every one."""
    o = np.asarray(CFG.origin, np.float32)[:, None]
    r = np.asarray(CFG.resolution, np.float32)[:, None]
    faces = (o + r * np.arange(CFG.dims[0], dtype=np.float32)[None]
             ).astype(np.float32)
    p = np.concatenate([faces + np.spacing(faces) * u
                        for u in range(-4, 5)], axis=1).astype(np.float32)
    true = np.floor((p - o) / r)
    recip = np.floor((p - o) * (np.float32(1.0) / r))
    assert (true != recip).sum() > 0, "no face point tells the forms apart"
    got = geometry.cell_coords(torch.from_numpy(p), CFG).numpy()
    np.testing.assert_array_equal(got, np.asarray(_jit_coords(
        jnp.asarray(p))))
    np.testing.assert_array_equal(got, recip.astype(np.int32))


@pytest.mark.parametrize("axis_aligned", [True, False])
def test_transform_bit_exact(axis_aligned):
    p = _points()
    pose = np.eye(4, dtype=np.float32)
    if axis_aligned:
        pose[:3, :3] = [[1, 0, 0], [0, -1, 0], [0, 0, -1]]
    else:
        q, _ = np.linalg.qr(RNG.normal(size=(3, 3)))
        pose[:3, :3] = q
    pose[:3, 3] = RNG.normal(size=3) * 0.1
    got = geometry.transform_points(torch.from_numpy(p),
                                    torch.from_numpy(pose)).numpy()
    want = np.asarray(jgeo.transform_points(jnp.asarray(p),
                                            jnp.asarray(pose)))
    if axis_aligned:
        # the sweeps' look-down poses: exact products, every result equal
        np.testing.assert_array_equal(got, want)
    else:
        # XLA on the CPU contracts the multiply-adds into FMAs; the port
        # rounds every operation, so a general rotation differs by ulps
        ulp = np.spacing(np.abs(want))
        assert np.max(np.abs(got - want) / ulp) <= 4
    # one rounding per operation: exactly the numpy f32 expression
    R, t = pose[:3, :3], pose[:3, 3]
    ref = np.stack([R[i, 0] * p[0] + R[i, 1] * p[1] + R[i, 2] * p[2] + t[i]
                    for i in range(3)])
    np.testing.assert_array_equal(got, ref)
    batched = geometry.transform_points(torch.from_numpy(p)[None],
                                        torch.from_numpy(pose)[None])
    np.testing.assert_array_equal(batched[0].numpy(), got)


def _cov(n):
    """Covariances of random point patches: planar, elongated, isotropic."""
    out = []
    for i in range(n):
        scale = np.asarray([1.0, 0.5 + RNG.random(), 1e-3 * (i % 7)])
        pts = RNG.normal(size=(30, 3)) * scale
        q, _ = np.linalg.qr(RNG.normal(size=(3, 3)))
        pts = pts @ q.T * 0.01
        out.append(np.cov(pts.T, bias=True))
    return np.asarray(out, np.float32)


def test_eigen_matches_jax_and_eigh():
    cov = _cov(512)
    idx = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    args = [cov[:, i, j] for i, j in idx]
    _, v = smallest_eigenpair_sym(*[torch.from_numpy(a) for a in args])
    _, jv = jax_eig(*[jnp.asarray(a) for a in args])
    v, jv = v.numpy().T, np.asarray(jv).T
    np.testing.assert_allclose(np.abs(np.sum(v * jv, axis=1)), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-5)
    w, e = np.linalg.eigh(cov.astype(np.float64))
    ref = e[:, :, 0]
    gap = (w[:, 1] - w[:, 0]) / np.maximum(w[:, 2], 1e-30)
    ok = gap > 1e-3                   # a defined smallest eigenvector
    assert ok.mean() > 0.8
    np.testing.assert_allclose(
        np.abs(np.sum(v[ok] * ref[ok], axis=1)), 1.0, atol=1e-5)
