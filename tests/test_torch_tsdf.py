"""The TSDF family of the port (models/tsdf.py, the plain versions of
kernels T1-T3 on the CPU) against the JAX package's, on one seeded
64x64 depth sweep (``make_depth_sweep``, ``small_test_config(refine_every
=0, z_clip=(0.05, 10.0))``, S=5 samples):

* the sample lanes bit for bit;
* the grid after K=8 batches by cell id (key set, counters, ``frames`` and
  ``vstats`` exactly), and after K=1 steps;
* the surface extract within the tolerances ``checks.py`` states;
* a too-small U budget: the same ``overflow_unique`` and dropped cells;
* a ``FusionSession(model="tsdf")`` run end to end, its PCD and CSV;
* the port's lane path against the NumPy oracle with the knife-edge rule
  of ``tests/test_tsdf_parity.py``.
"""

import dataclasses
import functools
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.io.pcd import read_metadata_csv, read_pcd
from hifi_fusion_tpu.models import tsdf as jtsdf
from hifi_fusion_tpu.ops.integrate import _unpack_inputs
from hifi_fusion_tpu.oracle.tsdf_oracle import TsdfOracle
from hifi_fusion_tpu.runtime.session import FusionSession as JaxSession
from hifi_fusion_tpu_torch import checks, convert
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.models import tsdf
from hifi_fusion_tpu_torch.ops import geometry
from hifi_fusion_tpu_torch.runtime.session import FusionSession
from hifi_fusion_tpu_torch.utils.synthetic import camera_rays, make_depth_sweep

KW = dict(refine_every=0, z_clip=(0.05, 10.0))
PARAMS = dict(truncation=0.011, n_samples=5, min_weight=2.0)
CFG = tsdf.TsdfConfig(base=small_test_config(**KW), **PARAMS)
JCFG = jtsdf.TsdfConfig(base=jax_config(**KW), **PARAMS)
K = CFG.base.max_batch_frames                      # 8, the session's K
RAYS = camera_rays(64, 64, fx=80.0, fy=80.0)
FRAMES = make_depth_sweep(CFG.base, 2 * K, width=64, height=64, srays=RAYS,
                          seed=2, noise_sd=1e-4, camera_height=0.4)
N = RAYS.shape[1]
C = CFG.base.capacity


def _batch(i, count=N):
    fs = FRAMES[K * i:K * i + K]
    counts = np.full((K,), N, np.int32)
    counts[3] = count                               # one short frame
    return (np.stack([f.depth_q for f in fs]),
            np.stack([f.rgb565 for f in fs]), counts,
            np.stack([f.pose for f in fs]))


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@functools.partial(jax.jit, static_argnames=("config",))
def _jax_lanes(depth_q, rgb565, counts, poses, rays, *, config):
    """The JAX package's batched lanes, as integrate_tsdf_batch_depth forms
    them (tsdf.py:206-210, 331-333)."""
    p, c, m = jax.vmap(lambda d, r, n: _unpack_inputs(d, r, n, None, rays)
                       )(depth_q, rgb565, counts)
    ks, kv = jax.vmap(lambda p_, c_, m_, t_: jtsdf._tsdf_lanes(
        p_, c_, m_, t_, config=config))(p, c, m, poses)
    return ks.reshape(-1), jnp.swapaxes(kv, 0, 1).reshape(6, -1)


def _jax_fields(g):
    return {f: np.asarray(getattr(g, f)) for f in g._fields}


def _jax_batches(config, n_batches, count=N):
    g = jtsdf.make_tsdf_grid(config)
    for i in range(n_batches):
        g = jtsdf.integrate_tsdf_batch_depth(
            g, *map(jnp.asarray, _batch(i, count)), jnp.asarray(RAYS),
            config=config)
    return g


def _port_batches(config, n_batches, count=N):
    g = tsdf.make_tsdf_grid(config, "cpu")
    for i in range(n_batches):
        tsdf.integrate_tsdf_batch_depth(g, *_t(_batch(i, count)),
                                        torch.from_numpy(RAYS), config)
    return g


@pytest.fixture(scope="module")
def grids():
    return _port_batches(CFG, 2, 3000), _jax_batches(JCFG, 2, 3000)


def _round_f32(x: Fraction) -> np.float32:
    """Exact round-to-nearest-even of a rational to f32."""
    f = np.float32(float(x))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f,
              np.nextafter(f, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - x)
        if best is None or d < best[0] or (
                d == best[0] and int(c.view(np.uint32)) % 2 == 0):
            best = (d, c)
    return best[1]


def test_fma_f32_is_one_rounding():
    """fma_f32 rounds a*b + c once, also where rounding the f64 sum first
    would land on an f32 midpoint."""
    rng = np.random.default_rng(3)
    n = 400
    a = rng.normal(size=n).astype(np.float32)
    b = (rng.normal(size=n) * 10.0 ** rng.integers(-12, 3, n)).astype(
        np.float32)
    c = rng.normal(size=n).astype(np.float32)
    # c + the f32 half-ulp of c: the exact sums sit next to a midpoint
    half = (np.spacing(c) / 2).astype(np.float32)
    a[:100], b[:100] = half[:100], np.float32(1.0) + np.float32(2.0 ** -23)
    a[100:200] = half[100:200] * np.float32(1.0 - 2.0 ** -24)
    b[100:200] = np.float32(1.0)
    got = geometry.fma_f32(*_t((a, b, c))).numpy()
    want = np.asarray([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                  + Fraction(float(z)))
                       for x, y, z in zip(a, b, c)], np.float32)
    assert got.tobytes() == want.tobytes()


def test_lanes_bit_identical_to_jax():
    args = _batch(0, 3000)
    ks, kv = map(np.asarray, _jax_lanes(*map(jnp.asarray, args),
                                        jnp.asarray(RAYS), config=JCFG))
    ps, pv = tsdf.tsdf_lanes(*_t(args), torch.from_numpy(RAYS), CFG)
    assert ps.shape == ks.shape == (K * 5 * N,)
    np.testing.assert_array_equal(ps.numpy(), ks)
    assert pv.numpy().tobytes() == kv.tobytes()
    valid = ks != np.iinfo(np.int32).max
    assert 0 < valid.sum() < valid.size             # the short frame


def test_batched_grid_matches_jax(grids):
    pg, jg = grids
    assert int(pg.frames) == 2 * K
    fields = convert.tsdf_grid_to_numpy(pg, CFG)
    assert checks.tsdf_grid_problems(fields, _jax_fields(jg), C) == []
    n = int((fields["key"] >= 0).sum())
    assert n > 1000 and int(pg.overflow_probe) == int(pg.overflow_unique) \
        == 0
    # the JAX state carried into the port and back is unchanged
    back = convert.tsdf_grid_to_numpy(
        convert.tsdf_grid_from_jax(_jax_fields(jg), CFG, "cpu"), CFG)
    live = {"key": C, "vstats": 6 * C}
    for f, a in _jax_fields(jg).items():
        n = live.get(f)
        if n is None:
            np.testing.assert_array_equal(back[f], a)
        else:
            np.testing.assert_array_equal(back[f][:n], a[:n])
    assert (back["key"][C:] == -1).all() and not back["vstats"][6 * C:].any()


def test_extract_matches_jax(grids):
    pg, jg = grids
    got = tsdf.tsdf_to_host(tsdf.extract_tsdf(pg, CFG))
    want = jtsdf.tsdf_to_host(jtsdf.extract_tsdf(jg, config=JCFG, cap=0))
    assert got["cell"].size > 500
    assert checks.tsdf_extract_problems(got, want) == []
    np.testing.assert_array_equal(got["rgb"], want["rgb"])
    np.testing.assert_allclose(np.linalg.norm(got["normal"], axis=1), 1.0,
                               atol=1e-5)


def test_single_steps_match_jax_and_batch():
    """K=1 steps equal the JAX package's K=1 steps exactly, and one K-batch
    up to f32 reassociation of the per-cell sums."""
    d, r, _, p = _batch(0)
    pg = tsdf.make_tsdf_grid(CFG, "cpu")
    jg = jtsdf.make_tsdf_grid(JCFG)
    for i in range(K):
        tsdf.integrate_tsdf_depth(
            pg, *_t((d[i], r[i], np.int32(N), p[i])),
            torch.from_numpy(RAYS), CFG)
        jg = jtsdf.integrate_tsdf_depth(
            jg, jnp.asarray(d[i]), jnp.asarray(r[i]), jnp.asarray(N),
            jnp.asarray(p[i]), jnp.asarray(RAYS), config=JCFG)
    steps = convert.tsdf_grid_to_numpy(pg, CFG)
    assert checks.tsdf_grid_problems(steps, _jax_fields(jg), C) == []
    a = checks.tsdf_by_cell(steps, C)
    b = checks.tsdf_by_cell(convert.tsdf_grid_to_numpy(
        _port_batches(CFG, 1), CFG), C)
    np.testing.assert_array_equal(a["cell"], b["cell"])
    assert a["frames"] == b["frames"] == K
    np.testing.assert_array_equal(a["vstats"][:, [0, 5]],
                                  b["vstats"][:, [0, 5]])
    np.testing.assert_allclose(a["vstats"], b["vstats"], rtol=1e-6,
                               atol=1e-7)


def test_unique_budget_overflow_matches_jax():
    """With U below the batch's distinct cells, both packages count the
    same overflow and keep the same (smallest-id) cells."""
    params = dict(PARAMS, batch_unique=2000)
    cfg = dataclasses.replace(CFG, batch_unique=2000)
    jcfg = jtsdf.TsdfConfig(base=JCFG.base, **params)
    pg, jg = _port_batches(cfg, 1), _jax_batches(jcfg, 1)
    fields = convert.tsdf_grid_to_numpy(pg, cfg)
    assert int(pg.overflow_unique) > 0
    assert checks.tsdf_grid_problems(fields, _jax_fields(jg), C) == []
    assert int((fields["key"] >= 0).sum()) == 2000


def test_session_end_to_end(tmp_path):
    """FusionSession(model="tsdf") on the CPU: one K=8 batch of the
    sweep's first 8 frames, process(), PCD + CSV; the same cells and
    counts as the JAX package's session."""
    out = {}
    for name, make in (
            ("port", lambda **kw: FusionSession(CFG.base, "cpu", **kw)),
            ("jax", lambda **kw: JaxSession(JCFG.base, **kw))):
        with make(output_dir=str(tmp_path / name), model="tsdf",
                  model_params=PARAMS, batch_fill_wait=2.0) as s:
            s.start()
            for f in FRAMES[:K]:
                assert s.push_depth_frame(f.depth_q, f.rgb565, f.pose,
                                          rays=RAYS)
            assert s.drain(600)
            assert s.metrics()["frames_integrated"] == K
            out[name] = s.process(ascii_mode=True)
    port, ref = out["port"], out["jax"]
    assert port["n_points"] == ref["n_points"] > 200
    # the port's counter of the cells each batch kept: one batch into an
    # empty grid keeps every cell it occupies
    pm = dict(port["grid_metrics"])
    assert pm.pop("unique_cells") == ref["grid_metrics"]["occupied_voxels"]
    assert pm == ref["grid_metrics"]
    cloud, n = read_pcd(port["cloud"])
    want, _ = read_pcd(ref["cloud"])
    assert n == port["n_points"]
    for f in ("x", "y", "z", "normal_x", "normal_y", "normal_z"):
        np.testing.assert_allclose(cloud[f], want[f], atol=1e-5)
    np.testing.assert_array_equal(cloud["rgb"].view(np.uint32),
                                  want["rgb"].view(np.uint32))
    meta, jmeta = read_metadata_csv(port["metadata"]), read_metadata_csv(
        ref["metadata"])
    np.testing.assert_array_equal(meta["count"], jmeta["count"])
    np.testing.assert_array_equal(meta["count"], port["host"]["count"])
    np.testing.assert_allclose(meta["mean_dist"], jmeta["mean_dist"],
                               atol=1e-6)


def test_lane_path_matches_numpy_oracle(grids):
    """The TSDF parity gate: the port's surface against the sequential
    NumPy oracle, cells exact except the knife-edge class of
    tests/test_tsdf_parity.py (cells whose |mean sdf| sits at the surface
    gate, where f32 summation order decides)."""
    pg, _ = grids
    orc = TsdfOracle(JCFG)
    for i in range(2):
        d, r, counts, p = _batch(i, 3000)
        rgb = torch.stack(_rgb_planes(r)).numpy()           # (3,K,N)
        for k in range(K):
            f = FRAMES[K * i + k]
            keep = (np.arange(N) < counts[k]) & (d[k] > 0)
            orc.integrate_frame(f.points_f32[:, keep].T,
                                rgb[:, k, keep].T, p[k])
    dev = tsdf.tsdf_to_host(tsdf.extract_tsdf(pg, CFG))
    ref = orc.extract()
    assert dev["cell"].size > 500
    dc, rc = set(dev["cell"].tolist()), set(ref["cell"].tolist())
    gate = np.float32(CFG.surface_band) * np.float32(
        CFG.base.resolution[0])
    for cid in dc ^ rc:
        acc = orc.cells[int(cid)]
        t = abs(np.float32(acc[1] / max(acc[0], 1e-9)))
        assert abs(t - gate) < 1e-8, (
            f"cell {cid} differs with |t|={t!r} not at the gate {gate!r}")
    assert len(dc ^ rc) <= 0.02 * len(rc)
    common = np.asarray(sorted(dc & rc))
    di = np.searchsorted(dev["cell"], common)
    ri = np.searchsorted(ref["cell"], common)
    np.testing.assert_allclose(dev["weight"][di], ref["weight"][ri],
                               atol=1.01)
    np.testing.assert_allclose(dev["tsdf"][di], ref["tsdf"][ri], atol=2e-4)
    dots = np.sum(dev["normal"][di] * ref["normal"][ri], axis=1)
    assert np.mean(dots > 0.99) > 0.98


def _rgb_planes(rgb565):
    v = torch.from_numpy(rgb565.astype(np.int32))
    return [((v >> 11) & 0x1F).float() * 8.0, ((v >> 5) & 0x3F).float() * 4.0,
            (v & 0x1F).float() * 8.0]
