"""The TSDF family's planar step (models/tsdf.py ``tsdf_lanes_planar``, the
plain version of kernel T2p on the CPU; ``step`` / ``step_batch``; the
session's ``push_frame``) against the JAX package's, on one seeded 64x64
depth sweep's unprojected points (``make_depth_sweep``, look-down poses,
``small_test_config(refine_every=0, z_clip=(0.05, 10.0))``, S=5 samples):

* the sample lanes bit for bit, with a (K,N) lane mask and with count
  prefixes;
* the grid after K=8 ``step_batch`` calls and after K=1 ``step`` calls by
  cell id: key set, counters, ``frames`` and ``vstats`` exactly;
* one general-rotation pose: the JAX package's jitted transform may round
  otherwise than the port's separately rounded one, so lanes may change
  cell where a sample sits within an ulp of a cell face; the test states
  the share it allows (at most 1e-4 of the valid lanes, here 0);
* the planar step against the depth step on the same frames' points:
  bit-identical lanes and grids;
* ``FusionSession(model="tsdf").push_frame`` against the JAX session's,
  and against the port's own ``push_depth_frame`` replay.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.models import tsdf as jtsdf
from hifi_fusion_tpu.runtime import decode as jdecode
from hifi_fusion_tpu.runtime.session import FusionSession as JaxSession
from hifi_fusion_tpu_torch import checks, convert
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.models import tsdf
from hifi_fusion_tpu_torch.runtime.decode import make_cloud_frame
from hifi_fusion_tpu_torch.runtime.session import FusionSession
from hifi_fusion_tpu_torch.utils.synthetic import camera_rays, make_depth_sweep

KW = dict(refine_every=0, z_clip=(0.05, 10.0))
PARAMS = dict(truncation=0.011, n_samples=5, min_weight=2.0)
CFG = tsdf.TsdfConfig(base=small_test_config(**KW), **PARAMS)
JCFG = jtsdf.TsdfConfig(base=jax_config(**KW), **PARAMS)
K = CFG.base.max_batch_frames                      # 8, the session's K
RAYS = camera_rays(64, 64, fx=80.0, fy=80.0)
FRAMES = make_depth_sweep(CFG.base, 2 * K, width=64, height=64, srays=RAYS,
                          seed=6, noise_sd=1e-4, camera_height=0.4)
N = RAYS.shape[1]
C = CFG.base.capacity
# a tenth of each frame's pixels without a return (depth 0), so the lane
# mask and the count prefixes select
for _f, _drop in zip(FRAMES, np.random.default_rng(7).random(
        (len(FRAMES), N)) < 0.1):
    _f.depth_q[_drop] = 0
    _f.points_f32[:, _drop] = 0.0
BIG = np.iinfo(np.int32).max


def _rgb8(rgb565):
    v = rgb565.astype(np.uint32)
    return np.stack([((v >> 11) & 0x1F) * 8, ((v >> 5) & 0x3F) * 4,
                     (v & 0x1F) * 8], axis=0).astype(np.float32)   # (3,n)


def _planar(idx, wire="bool"):
    """Frames ``idx`` on the planar wire: (k,3,N) f32 points and colour,
    and a (k,N) bool mask of the valid pixels (``bool``) or the valid
    pixels packed to a count prefix (``count``), and (k,4,4) poses."""
    fs = [FRAMES[i] for i in idx]
    poses = np.stack([f.pose for f in fs])
    if wire == "bool":
        return (np.stack([f.points_f32 for f in fs]),
                np.stack([_rgb8(f.rgb565) for f in fs]),
                np.stack([f.depth_q > 0 for f in fs]), poses)
    pts = np.zeros((len(fs), 3, N), np.float32)
    rgb = np.zeros((len(fs), 3, N), np.float32)
    counts = np.zeros((len(fs),), np.int32)
    for k, f in enumerate(fs):
        keep = f.depth_q > 0
        n = int(keep.sum())
        pts[k, :, :n] = f.points_f32[:, keep]
        rgb[k, :, :n] = _rgb8(f.rgb565[keep])
        counts[k] = n
    return pts, rgb, counts, poses


def _jax_mask(mask):
    """A count-prefix wire as the (k,N) bool mask the JAX step takes."""
    if mask.dtype == np.bool_:
        return mask
    return np.arange(N)[None, :] < mask[:, None]


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@functools.partial(jax.jit, static_argnames=("config",))
def _jax_lanes(points, rgb, mask, poses, *, config):
    """The JAX package's batched planar lanes (tsdf.py:206-210)."""
    ks, kv = jax.vmap(lambda p, c, m, t: jtsdf._tsdf_lanes(
        p, c, m, t, config=config))(points, rgb, mask, poses)
    return ks.reshape(-1), jnp.swapaxes(kv, 0, 1).reshape(6, -1)


def _jax_fields(g):
    return {f: np.asarray(getattr(g, f)) for f in g._fields}


def _general_pose(pose):
    """The look-down pose turned by ~7 degrees about a skew axis through
    the camera: every entry of the rotation is a general f32."""
    a = np.asarray([0.3, -0.5, 0.8])
    a /= np.linalg.norm(a)
    t = np.deg2rad(7.0)
    Kx = np.asarray([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    R = np.eye(3) + np.sin(t) * Kx + (1 - np.cos(t)) * Kx @ Kx
    out = pose.astype(np.float64).copy()
    out[:3, :3] = R @ out[:3, :3]
    return out.astype(np.float32)


@pytest.mark.parametrize("wire", ["bool", "count"])
def test_planar_lanes_bit_identical_to_jax(wire):
    pts, rgb, mask, poses = _planar(range(K), wire)
    ks, kv = map(np.asarray, _jax_lanes(
        *map(jnp.asarray, (pts, rgb, _jax_mask(mask), poses)), config=JCFG))
    ps, pv = tsdf.tsdf_lanes_planar(*_t((pts, rgb, mask, poses)), CFG)
    assert ps.shape == ks.shape == (K * 5 * N,)
    np.testing.assert_array_equal(ps.numpy(), ks)
    assert pv.numpy().tobytes() == kv.tobytes()
    valid = ks != BIG
    assert 0 < valid.sum() < valid.size


def test_general_pose_lanes_within_stated_share():
    """A general rotation: the JAX package's jitted transform against the
    port's separately rounded one.  Keys may differ only on lanes whose
    sample moved across a cell face by the transform's last-bit rounding:
    at most 1e-4 of the valid lanes; the values of every lane whose key
    agrees are bit-identical."""
    pts, rgb, mask, poses = _planar(range(2))
    poses = np.stack([_general_pose(p) for p in poses])
    ks, kv = map(np.asarray, _jax_lanes(
        *map(jnp.asarray, (pts, rgb, mask, poses)), config=JCFG))
    ps, pv = (a.numpy() for a in tsdf.tsdf_lanes_planar(
        *_t((pts, rgb, mask, poses)), CFG))
    valid = (ks != BIG) | (ps != BIG)
    differ = ps != ks
    assert valid.sum() > 10000
    assert differ.sum() <= 1e-4 * valid.sum(), int(differ.sum())
    same = ~differ
    assert pv[:, same].tobytes() == kv[:, same].tobytes()


@pytest.fixture(scope="module")
def batched():
    """Both packages' grids after two K=8 ``step_batch`` calls on the
    count-prefix wire (the port) and its mask (the JAX package)."""
    pipe = tsdf.TsdfPipeline(CFG, "cpu")
    g = pipe.init()
    jpipe = jtsdf.TsdfPipeline(JCFG)
    jg = jpipe.init()
    for b in range(2):
        pts, rgb, counts, poses = _planar(range(K * b, K * b + K), "count")
        pipe.step_batch(g, *_t((pts, rgb, counts, poses)))
        jg = jpipe.step_batch(jg, *map(jnp.asarray, (
            pts, rgb, _jax_mask(counts), poses)))
    return g, jg


def test_step_batch_matches_jax(batched):
    g, jg = batched
    fields = convert.tsdf_grid_to_numpy(g, CFG)
    assert checks.tsdf_grid_problems(fields, _jax_fields(jg), C) == []
    assert int(g.frames) == 2 * K
    assert int((fields["key"] >= 0).sum()) > 1000
    assert int(g.overflow_probe) == int(g.overflow_unique) == 0


def test_extract_after_planar_batches_matches_jax(batched):
    g, jg = batched
    got = tsdf.tsdf_to_host(tsdf.extract_tsdf(g, CFG))
    want = jtsdf.tsdf_to_host(jtsdf.extract_tsdf(jg, config=JCFG, cap=0))
    assert got["cell"].size > 300
    assert checks.tsdf_extract_problems(got, want) == []


def test_step_matches_jax():
    """K=1 ``step`` calls, the lane mask on the port's side for half the
    frames and a 0-d count for the other half."""
    pipe = tsdf.TsdfPipeline(CFG, "cpu")
    g = pipe.init()
    jpipe = jtsdf.TsdfPipeline(JCFG)
    jg = jpipe.init()
    for i in range(4):
        wire = "bool" if i % 2 else "count"
        pts, rgb, mask, poses = _planar([i], wire)
        m = torch.from_numpy(mask[0]) if wire == "bool" else \
            torch.tensor(int(mask[0]), dtype=torch.int32)
        p, c, t = _t((pts[0], rgb[0], poses[0]))
        pipe.step(g, p, c, m, t)
        jg = jpipe.step(jg, *map(jnp.asarray, (
            pts[0], rgb[0], _jax_mask(mask)[0], poses[0])))
    fields = convert.tsdf_grid_to_numpy(g, CFG)
    assert int(g.frames) == 4
    assert checks.tsdf_grid_problems(fields, _jax_fields(jg), C) == []


def test_planar_step_equals_depth_step():
    """The depth frames' unprojected points on the planar wire give the
    depth wire's lanes bit for bit, and so the same grid."""
    idx = range(K)
    pts, rgb, mask, poses = _planar(idx, "bool")
    fs = [FRAMES[i] for i in idx]
    depth = (np.stack([f.depth_q for f in fs]),
             np.stack([f.rgb565 for f in fs]),
             np.full((K,), N, np.int32), poses)
    dk, dv = tsdf.tsdf_lanes(*_t(depth), torch.from_numpy(RAYS), CFG)
    pk, pv = tsdf.tsdf_lanes_planar(*_t((pts, rgb, mask, poses)), CFG)
    assert torch.equal(dk, pk)
    assert dv.numpy().tobytes() == pv.numpy().tobytes()
    gd, gp = tsdf.make_tsdf_grid(CFG, "cpu"), tsdf.make_tsdf_grid(CFG, "cpu")
    tsdf.integrate_tsdf_batch_depth(gd, *_t(depth), torch.from_numpy(RAYS),
                                    CFG)
    tsdf.integrate_tsdf_batch(gp, *_t((pts, rgb, mask, poses)), CFG)
    assert checks.tsdf_grid_problems(convert.tsdf_grid_to_numpy(gp, CFG),
                                     convert.tsdf_grid_to_numpy(gd, CFG),
                                     C) == []


def _clouds(idx):
    out = []
    for i in idx:
        f = FRAMES[i]
        keep = f.depth_q > 0
        out.append((f.points_f32[:, keep].T.copy(),
                    _rgb8(f.rgb565[keep]).T.copy(), f.pose))
    return out


def _session_run(kind, out, clouds):
    kw = dict(output_dir=out, model="tsdf", model_params=PARAMS,
              batch_fill_wait=2.0)
    if kind == "jax":
        s = JaxSession(JCFG.base, **kw)
    else:
        s = FusionSession(CFG.base, "cpu", **kw)
    with s:
        s.start()
        for i, (xyz, rgb, pose) in enumerate(clouds):
            if kind == "jax":
                fr = jdecode.make_cloud_frame(xyz, rgb)
                assert s.push_frame(fr, pose)
            elif kind == "depth":
                f = FRAMES[i]
                assert s.push_depth_frame(f.depth_q, f.rgb565, f.pose,
                                          rays=RAYS)
            else:
                assert s.push_frame(make_cloud_frame(xyz, rgb), pose)
        assert s.drain(600)
        m = s.metrics()
        assert m["frames_integrated"] == len(clouds)
        return s.process(), m


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tsdf_planar")
    clouds = _clouds(range(K))
    return {kind: _session_run(kind, str(tmp / kind), clouds)
            for kind in ("port", "jax", "depth")}


def test_session_push_frame_matches_jax(sessions):
    (port, m), (ref, jm) = sessions["port"], sessions["jax"]
    assert m["pose_failures"] == m["frames_truncated"] == 0
    assert m["dispatch_errors"] == 0 and m["decode_s"] > 0
    assert port["n_points"] == ref["n_points"] > 200
    # the port's counter of the cells each batch kept: one batch into an
    # empty grid keeps every cell it occupies
    pm = dict(port["grid_metrics"])
    assert pm.pop("unique_cells") == ref["grid_metrics"]["occupied_voxels"]
    assert pm == ref["grid_metrics"]
    from hifi_fusion_tpu.io.pcd import read_metadata_csv, read_pcd
    cloud, n = read_pcd(port["cloud"])
    want, _ = read_pcd(ref["cloud"])
    assert n == port["n_points"]
    for f in ("x", "y", "z", "normal_x", "normal_y", "normal_z"):
        np.testing.assert_allclose(cloud[f], want[f], atol=1e-5)
    np.testing.assert_array_equal(cloud["rgb"].view(np.uint32),
                                  want["rgb"].view(np.uint32))
    np.testing.assert_array_equal(read_metadata_csv(port["metadata"])
                                  ["count"],
                                  read_metadata_csv(ref["metadata"])["count"])


def test_session_push_frame_equals_push_depth_frame(sessions):
    (port, _), (depth, md) = sessions["port"], sessions["depth"]
    assert md["decode_s"] == 0
    a, b = port["host"], depth["host"]
    for f in ("cell", "count", "rgb", "centroid", "normal", "mean_dist"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert port["grid_metrics"] == depth["grid_metrics"]
