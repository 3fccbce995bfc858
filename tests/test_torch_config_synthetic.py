"""Guards of the port: the copied config and synthetic sweep equal the JAX
package's, the writers produce the same bytes, and importing the port
loads neither ``jax`` nor ``hifi_fusion_tpu``."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from hifi_fusion_tpu import config as jconfig
from hifi_fusion_tpu.io import pcd as jpcd
from hifi_fusion_tpu.utils import synthetic as jsyn
from hifi_fusion_tpu_torch import config
from hifi_fusion_tpu_torch.io import pcd
from hifi_fusion_tpu_torch.utils import synthetic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROPS = ("dims", "global_x_cells", "n_cells", "capacity", "buffer_capacity",
         "origin", "scatter_tail", "n_occ_words", "n_offsets", "n_line")


@pytest.mark.parametrize("overrides", [
    {}, {"refine_every": 8, "max_batch_frames": 8, "capacity_log2": 10},
    {"bbox": (-0.35, 0.35, -0.35, 0.35, 0.0, 0.4),
     "resolution": (0.001, 0.001, 0.001), "capacity_log2": 22}])
def test_config_copy_matches_jax(overrides):
    fa = [(f.name, f.default) for f in dataclasses.fields(config.FusionConfig)]
    fb = [(f.name, f.default)
          for f in dataclasses.fields(jconfig.FusionConfig)]
    assert fa == fb
    for make in ("small_test_config", "FusionConfig"):
        a = getattr(config, make)(**overrides)
        b = getattr(jconfig, make)(**overrides)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        for p in PROPS:
            assert getattr(a, p) == getattr(b, p), p
    with pytest.raises(ValueError):
        config.small_test_config(capacity_log2=25)


def test_depth_sweep_byte_identical():
    cfg = config.small_test_config()
    rays = synthetic.camera_rays(48, 32, fx=60.0, fy=60.0)
    np.testing.assert_array_equal(rays, jsyn.camera_rays(48, 32, fx=60.0,
                                                         fy=60.0))
    a = synthetic.make_depth_sweep(cfg, 3, width=48, height=32, srays=rays,
                                   seed=4, arc_frames=10)
    b = jsyn.make_depth_sweep(jconfig.small_test_config(), 3, width=48,
                              height=32, srays=rays, seed=4, arc_frames=10)
    for fa, fb in zip(a, b):
        for f in ("depth_q", "rgb565", "pose", "points_f32"):
            x, y = getattr(fa, f), getattr(fb, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
        assert fa.count == fb.count
    assert synthetic.DEPTH_SCALE == jsyn.DEPTH_SCALE


def test_planar_sweep_byte_identical():
    """``make_sweep``, ``pad_frame`` and ``pack_frame_q16`` give the JAX
    package's bytes for one seed."""
    cfg = config.small_test_config()
    a = synthetic.make_sweep(cfg, 3, 500, seed=7, noise_sd=5e-4)
    b = jsyn.make_sweep(jconfig.small_test_config(), 3, 500, seed=7,
                        noise_sd=5e-4)
    for fa, fb in zip(a, b):
        for f in ("points_cam", "rgb", "pose", "mask"):
            x, y = getattr(fa, f), getattr(fb, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
        pa, pb = synthetic.pad_frame(fa, 640), jsyn.pad_frame(fb, 640)
        qa = synthetic.pack_frame_q16(fa, 640)
        qb = jsyn.pack_frame_q16(fb, 640)
        for x, y in ((pa.points_cam, pb.points_cam), (pa.rgb, pb.rgb),
                     (pa.mask, pb.mask), (qa.points_q, qb.points_q),
                     (qa.quant, qb.quant), (qa.rgb_u32, qb.rgb_u32),
                     (qa.pose, qb.pose), (qa.points_f32, qb.points_f32)):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
        assert qa.count == qb.count == 500
    with pytest.raises(ValueError):
        synthetic.pad_frame(a[0], 100)


@pytest.mark.parametrize("ascii_mode", [True, False])
def test_writers_byte_identical(tmp_path, ascii_mode):
    rng = np.random.default_rng(2)
    n = 257
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = (rng.random((n, 3)) * 300 - 20).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    a, b = tmp_path / "a.pcd", tmp_path / "b.pcd"
    pcd.write_pcd_xyzrgbnormal(str(a), xyz, rgb, nrm, ascii_mode=ascii_mode)
    jpcd.write_pcd_xyzrgbnormal(str(b), xyz, rgb, nrm, ascii_mode=ascii_mode)
    assert a.read_bytes() == b.read_bytes()
    sd = rng.random((n, 3)).astype(np.float32) * 1e-6
    md, sdd = rng.random(n).astype(np.float32), rng.random(n).astype(
        np.float32)
    cnt = rng.integers(0, 500, n)
    pcd.write_metadata_csv(str(a) + ".csv", sd, md, sdd, cnt)
    jpcd.write_metadata_csv(str(b) + ".csv", sd, md, sdd, cnt)
    assert (tmp_path / "a.pcd.csv").read_bytes() == \
        (tmp_path / "b.pcd.csv").read_bytes()


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys, tempfile, os\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'hifi_fusion_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import hifi_fusion_tpu_torch as p\n"
        "n = 0\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name); n += 1\n"
        "from hifi_fusion_tpu_torch.config import small_test_config\n"
        "from hifi_fusion_tpu_torch.runtime.decode import (decode_frame,"
        " make_cloud_frame)\n"
        "from hifi_fusion_tpu_torch.utils.synthetic import (make_sweep,"
        " pack_frame_q16, pad_frame)\n"
        "from hifi_fusion_tpu_torch.io import downloads, pcd, ply\n"
        "from hifi_fusion_tpu_torch.oracle.native import NativeOracle\n"
        "from hifi_fusion_tpu_torch.runtime.sources import SyntheticSource\n"
        "from hifi_fusion_tpu_torch.utils.profiling import StageTimers\n"
        "cfg = small_test_config()\n"
        "f = make_sweep(cfg, 1, 50, seed=1)[0]\n"
        "pad_frame(f, 64); pack_frame_q16(f, 64)\n"
        "xyz, _ = decode_frame(make_cloud_frame(f.points_cam, f.rgb))\n"
        "assert (xyz == f.points_cam).all()\n"
        "d = tempfile.mkdtemp()\n"
        "pcd.write_pcd_xyzrgb(os.path.join(d, 'a.pcd'), xyz, f.rgb)\n"
        "assert pcd.read_pcd(os.path.join(d, 'a.pcd'))[1] == 50\n"
        "ply.write_ply(os.path.join(d, 'a.ply'), xyz, f.rgb, xyz)\n"
        "assert ply.read_ply(os.path.join(d, 'a.ply'))['xyz'].shape"
        " == (50, 3)\n"
        "h = {'centroid': xyz, 'rgb': f.rgb, 'normal': xyz}\n"
        "assert downloads.download_with_normals(h)['xyz'].shape == (50, 3)\n"
        "o = NativeOracle(cfg)\n"
        "for fr in make_sweep(cfg, 2, 300, seed=2):\n"
        "    o.integrate_frame(fr.points_cam, None, fr.pose)\n"
        "o.refine(); assert o.n_voxels() > 0\n"
        "assert len(SyntheticSource(cfg, 2, 10)) == 2\n"
        "t = StageTimers()\n"
        "with t.stage('decode'): pass\n"
        "assert list(t.report()) == ['decode']\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'hifi_fusion_tpu' or m.startswith('hifi_fusion_tpu.')]\n"
        "assert not bad, bad\n"
        "assert n >= 31, n\n"
        "print('ok', n)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
