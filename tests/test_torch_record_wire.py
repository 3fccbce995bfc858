"""The record wire of the planar frontend (``ops/integrate.record_frontend``)
against the host decode it replaces: ``runtime/decode._decode_numpy`` of
each frame, cut to ``max_points`` and packed as the session's planar
batch, then ``planar_frontend_plain``.  Every output word is compared
(NaN lanes as NaN).  The plain version runs on the CPU; on a CUDA card
the same cases hold kernel K5's record wire to the reference computed
there.  No JAX: on the card, run it as

    python -m pytest -m cuda --noconftest tests/test_torch_record_wire.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from hifi_fusion_tpu_torch import kernels
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.ops import integrate
from hifi_fusion_tpu_torch.runtime import decode
from hifi_fusion_tpu_torch.utils.synthetic import make_sweep

N = 1500
CFG = small_test_config(z_clip=(0.05, 10.0), max_points=N)
SWEEP = make_sweep(CFG, 8, 1800, seed=11)

# record layouts: point_step and each field's byte offset
LAYOUTS = {
    "aligned16": (16, {"x": 0, "y": 4, "z": 8, "rgb": 12}),
    "padded32": (32, {"x": 4, "y": 12, "z": 20, "rgb": 28}),
    "window16": (32, {"rgb": 16, "z": 20, "x": 24, "y": 28}),
    "unaligned": (18, {"x": 1, "y": 5, "z": 9, "rgb": 14}),
    "no_rgb": (16, {"x": 0, "y": 4, "z": 8}),
}
# (layout, K, frame sizes, blue-shift bug, NaN points); sizes past N are
# cut to N
CASES = {
    "aligned16-k8": ("aligned16", 8, (900, 1500, 0, 1200, 37, 1499, 1000,
                                      640), False, False),
    "padded32-k8": ("padded32", 8, (1100, 300, 1500, 900, 1, 700, 1300,
                                    1450), False, False),
    "window16-k1": ("window16", 1, (1200,), False, False),
    "unaligned-k8": ("unaligned", 8, (1000, 1499, 1, 800, 1200, 0, 600,
                                      1500), False, False),
    "no_rgb-k8": ("no_rgb", 8, (1000,) * 8, False, False),
    "blue_shift-k8": ("aligned16", 8, (1300, 900, 1000, 1100, 1200, 1400,
                                       500, 1500), True, False),
    "nan-k8": ("aligned16", 8, (1500, 1200, 1000, 1100, 900, 1400, 800,
                                1300), False, True),
    "truncated-k8": ("padded32", 8, (1800, 1501, 1500, 900, 1800, 200,
                                     1700, 1000), False, False),
    "aligned16-k1": ("aligned16", 1, (1400,), False, False),
    "truncated-k1": ("unaligned", 1, (1800,), True, True),
}


def _frame(f, n, layout, rng, nan):
    """Sweep frame ``f``'s first ``n`` points as records of ``layout``,
    random filler bytes between the fields."""
    step, offs = LAYOUTS[layout]
    fr = SWEEP[f]
    xyz = fr.points_cam[:n].astype(np.float32).copy()
    if nan:
        xyz[::7, rng.integers(0, 3)] = np.nan
    raw = rng.integers(0, 256, (n, step), dtype=np.uint8)
    for a, name in enumerate("xyz"):
        raw[:, offs[name]:offs[name] + 4] = xyz[:, a:a + 1].view(np.uint8)
    if "rgb" in offs:
        c = np.clip(fr.rgb[:n], 0, 255).astype(np.uint32)
        word = ((c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
                | (rng.integers(0, 256, n).astype(np.uint32) << 24))
        raw[:, offs["rgb"]:offs["rgb"] + 4] = word[:, None].view(np.uint8)
    return decode.CloudFrame(raw.tobytes(), step, n,
                             fields=[decode.PointField(k, o)
                                     for k, o in offs.items()])


def _inputs(case):
    layout, K, sizes, bug, nan = CASES[case]
    rng = np.random.default_rng(len(case) + K)
    frames = [_frame(k, n, layout, rng, nan) for k, n in enumerate(sizes)]
    poses = np.stack([SWEEP[k].pose for k in range(K)])
    cfg = dataclasses.replace(CFG, bug_compat_blue_shift=bug)
    return frames, poses, cfg


def _record_batch(frames):
    """The session's record wire of ``frames``: each frame's first
    ``max_points`` records in a row of ``max_points * point_step`` bytes
    (filler past them), and the (K,6) frame table."""
    rows = [decode.record_fields(f) for f in frames]
    row = N * max(r[1] for r in rows)
    rec = np.full((len(frames), row), 0xA5, np.uint8)
    table = np.empty((len(frames), 6), np.int32)
    for k, (f, (n, *layout)) in enumerate(zip(frames, rows)):
        table[k] = [min(n, N), *layout]
        nbytes = table[k, 0] * table[k, 1]
        rec[k, :nbytes] = np.frombuffer(f.data, np.uint8, count=nbytes)
    return rec, table


def _host_decode(frames, poses, cfg, dev):
    """The host decode's outputs: ``_decode_numpy`` a frame, packed into
    the zero-padded (K,3,N) f32 wire with a count prefix, through
    ``planar_frontend_plain`` on ``dev``."""
    K = len(frames)
    pts = np.zeros((K, 3, N), np.float32)
    rgb = np.zeros((K, 3, N), np.float32)
    counts = np.zeros((K,), np.int32)
    for k, f in enumerate(frames):
        _, _, ox, oy, oz, orgb = decode.record_fields(f)
        xyz, col = decode._decode_numpy(f, ox, oy, oz,
                                        None if orgb < 0 else orgb,
                                        cfg.bug_compat_blue_shift)
        n = min(xyz.shape[0], N)
        pts[k, :, :n], rgb[k, :, :n], counts[k] = xyz[:n].T, col[:n].T, n
    return integrate.planar_frontend_plain(
        *(torch.from_numpy(a).to(dev) for a in (pts, rgb, counts, poses)),
        None, cfg)


def _same(a, b):
    """Equal words, NaN where the other is NaN."""
    if a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = a.masked_fill(nan, 0), b.masked_fill(nan, 0)
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("case", list(CASES))
def test_record_wire_equals_host_decode(case, device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    frames, poses, cfg = _inputs(case)
    want = _host_decode(frames, poses, cfg, device)
    rec, table = _record_batch(frames)
    n0 = kernels.LAUNCHES["record_frontend"]
    got = integrate.record_frontend(
        *(torch.from_numpy(a).to(device) for a in (rec, table, poses)), cfg)
    assert kernels.LAUNCHES["record_frontend"] == n0 + (device == "cuda")
    assert all(_same(g, w) for g, w in zip(got, want))
    n_valid = int((got[1] != integrate.INVALID_ID).sum())
    assert 0 < n_valid < got[1].numel()


def test_record_fields_refuses_what_decode_refuses():
    """A missing coordinate, a short buffer and a field past the record
    raise in ``record_fields`` and in the native decode alike."""
    good = decode.make_cloud_frame(SWEEP[0].points_cam[:10],
                                   SWEEP[0].rgb[:10])
    assert decode.record_fields(good) == (10, 16, 0, 4, 8, 12)
    bad = [dataclasses.replace(good, fields=good.fields[:2]),
           dataclasses.replace(good, data=good.data[:-1]),
           dataclasses.replace(good, fields=good.fields[:3]
                               + [decode.PointField("rgb", 13)])]
    for f in bad:
        with pytest.raises(ValueError):
            decode.record_fields(f)
        with pytest.raises(ValueError):
            decode.decode_frame(f)


@pytest.mark.parametrize("device", DEVICES)
def test_record_wire_reads_inside_rows(device):
    """A table that does not fit its rows (a count past the row, a field
    past the record, a step or offset below zero) makes no read outside
    them: those lanes take the padding's zeros, and the kernel agrees with
    the plain version."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    frames, poses, cfg = _inputs("aligned16-k8")
    rec, _ = _record_batch(frames[:4])
    rec = np.ascontiguousarray(rec[:, :1600])            # 100 records a row
    table = np.asarray([[N, 16, 0, 4, 8, 12], [N, 16, 0, 4, 8, 1592],
                        [10, -16, 0, 4, 8, 12], [10, 16, -4, 4, 8, 12]],
                       np.int32)
    args = [torch.from_numpy(a).to(device) for a in (rec, table, poses[:4])]
    got = integrate.record_frontend(*args, cfg)
    want = integrate.record_frontend_plain(*args, cfg)
    assert all(_same(g, w) for g, w in zip(got, want))
    live = np.zeros((4, N), bool)
    live[0, :100] = True                 # whole records in the row
    live[1, :1] = True                   # the colour word ends at 1596
    ids = got[1].cpu().numpy().reshape(4, N)
    assert (ids[~live] == integrate.INVALID_ID).all()
    assert (ids[0, :100] != integrate.INVALID_ID).any()
    assert not got[2].cpu().numpy().reshape(3, 4, N)[:, ~live].any()
