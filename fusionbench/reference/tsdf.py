"""Plain PyTorch reference of the ray-sampled TSDF fusion.

A restatement of the TSDF family's equations (``models/tsdf.py``'s
docstring in the program: each valid point places S samples along its
camera ray at the centered offsets ``(s - (S-1)/2) * step`` inside
+-truncation, and a sample's cell accumulates ``[w, w*sdf, r, g, b,
n_rgb]`` with w = 1, sdf = -offset and the colour on the middle sample
only; the surface is every cell with enough weight and a mean signed
distance inside the band, placed on the zero crossing along the TSDF's
gradient), written from that description with torch alone.  It imports
nothing of the program, has no hash table, no kernels, no sort-and-scan
and no budgets, and runs on any torch device.

Per frame (its valid pixels' camera points and 8-bit colour, and the
camera's pose):

* the clip ``z_min < z < z_max`` in the camera frame;
* the transform ``world = ((R0 x + R1 y) + R2 z) + t``, one rounding a
  step;
* the ray ``world - camera``, its length ``sqrt(x^2 + y^2 + z^2)`` and its
  direction ``ray / max(length, 1e-6)``;
* the S samples: ``step = 2 tau / (S - 1)`` worked out in float64 and
  rounded once, offsets ``o_s = (s - (S-1)/2) * step``, positions
  ``world + o_s * dir``;
* the band test: a sample counts when its point passed the clip, its
  position lies strictly inside the bbox and its cell ``floor((p -
  origin) / res)`` inside the grid;
* its cell id ``(x * dy + y) * dz + z``.

Per cell, over the whole sweep: the sums of ``[w, w*sdf, r, g, b, n_rgb]``
in ``acc`` (float64: the reference's own rounding is far below the
program's float32 sums).  The extract: the cells with ``w >= min_weight``
and ``|tsdf| < surface_band * res_x`` (``tsdf = sum(w sdf) / sum(w)``), in
ascending id; per axis the neighbours at +-1 that were observed give the
central or one-sided difference of ``tsdf`` over the cells' spacing (a
side with no observed neighbour takes the cell's own value); the normal is
the difference vector over its length (``(gx, gy, 1)`` when the length is
below 1e-9); the centroid ``center - tsdf * normal``; the colour ``sum(rgb)
/ max(n_rgb, 1)``.

Where it departs from plain real arithmetic, it does so to land each
sample in the cell the program's float32 arithmetic gives it, so that the
comparison measures the program's sums and not a binning of its own:

* the squared length and the sample position are fused multiply-adds
  (``fma(z, z, fma(y, y, x*x))``, ``fma(o_s, dir, world)``: the product
  and the sum in float64, rounded once to ``ftype``), as the compiled
  TPU programs of the original system contract them;
* the cell is ``floor((p - origin) * inv)`` with ``inv`` the ``ftype``
  reciprocal of ``res`` rounded once, as those programs fold a division
  by a constant.

It counts its work: ``lanes_valid`` (samples that passed the band test),
and for each batch of ``K`` frames in arrival order the distinct cells
its samples hit (``batch_cells``) and of those the ones no earlier batch
of the sweep hit (``batch_new``); ``unique_cells`` is the sum of
``batch_cells``.

``ftype`` is the precision of the geometry (float32 as the configuration
states; bfloat16 for the control), ``acc`` the precision of the sums.
"""

from __future__ import annotations

import torch

from .fusion import Geometry, transform

F64 = torch.float64


def batch_frames(fc: dict) -> int:
    """The frames of a batch: the largest K <= ``max_batch_frames`` that
    divides the refine marks' spacing and the first mark (every K when
    there is no refine)."""
    kb = max(int(fc.get("max_batch_frames", 8)), 1)
    e = int(fc.get("refine_every", 16))
    if e > 0:
        f0 = int(fc.get("refine_first", 0))
        while e % kb or (f0 > 0 and f0 % kb):
            kb -= 1
    return kb


def fma(a, b, c, ftype):
    """``a*b + c`` rounded once to ``ftype``: the product and the sum in
    float64."""
    return (a.to(F64) * b.to(F64) + c.to(F64)).to(ftype)


class TsdfReference:
    """The TSDF sums as sorted unique cell ids and their (n,6) sums."""

    def __init__(self, cfg: dict, device, ftype=torch.float32,
                 acc=torch.float64):
        fc = cfg["fusion_config"]
        mp = cfg["model_params"]
        self.fc, self.ftype, self.acc = fc, ftype, acc
        self.geo = Geometry(fc, device, ftype)
        self.dev = self.geo.device
        self.S = int(mp["n_samples"])
        self.tau = float(mp["truncation"])
        self.min_weight = float(mp["min_weight"])
        self.band = float(mp.get("surface_band", 1.0))
        col = dict(dtype=ftype, device=self.dev)
        step = torch.tensor(2.0 * self.tau / (self.S - 1), **col)
        half = torch.tensor((self.S - 1) / 2.0, **col)
        self.offsets = (torch.arange(self.S, **col) - half) * step
        self.inv = torch.tensor(1.0, **col) / self.geo.res
        self.cell = torch.zeros(0, dtype=torch.int64, device=self.dev)
        self.sums = torch.zeros((0, 6), dtype=acc, device=self.dev)
        self.lanes_valid = 0
        self.batch_cells, self.batch_new = [], []

    def samples(self, pc, rgb, pose):
        """One frame's (n,3) camera points and colour -> the cell ids
        (m,) of its samples in the band and their (m,6) values."""
        g, ft, dev = self.geo, self.ftype, self.dev
        pc = pc.to(ft)
        z0, z1 = (torch.tensor(z, dtype=ft, device=dev)
                  for z in self.fc["z_clip"])
        keep = (pc[:, 2] > z0) & (pc[:, 2] < z1)
        pc, rgb = pc[keep], rgb[keep].to(ft)
        pose = pose.to(dev)
        world = transform(pc, pose)                           # (n,3)
        ray = world - pose[:3, 3].to(ft)
        x, y, z = ray[:, 0], ray[:, 1], ray[:, 2]
        dist = torch.sqrt(fma(z, z, fma(y, y, x * x, ft), ft))
        eps = torch.tensor(1e-6, dtype=ft, device=dev)
        dirn = ray / torch.maximum(dist, eps)[:, None]
        o = self.offsets
        pos = fma(o[:, None, None], dirn[None], world[None], ft)  # (S,n,3)
        pos = pos.reshape(-1, 3)
        c = torch.floor((pos - g.origin) * self.inv).to(torch.int64)
        ok = g.inside(pos) & g.valid(c)
        ids = g.cell_id(c[ok])
        s_idx = torch.arange(self.S, device=dev).repeat_interleave(
            pc.shape[0])[ok]
        mid = (s_idx == self.S // 2).to(self.acc)
        cols = rgb.repeat(self.S, 1)[ok].to(self.acc) * mid[:, None]
        vals = torch.cat([torch.ones_like(mid)[:, None],
                          (-o).to(self.acc)[s_idx][:, None], cols,
                          mid[:, None]], dim=1)
        return ids, vals

    def _sum(self, ids, vals):
        """Distinct ids and their (n,6) sums of rows ``vals`` in ``acc``."""
        cells, inv = torch.unique(ids, return_inverse=True)
        return cells, torch.zeros((cells.numel(), 6), dtype=self.acc,
                                  device=self.dev).index_add_(0, inv, vals)

    def integrate(self, frames) -> None:
        """A batch of ``(pc, rgb, pose)`` frames, in arrival order."""
        parts = []
        for f in frames:
            ids, vals = self.samples(*f)
            self.lanes_valid += int(ids.numel())
            parts.append(self._sum(ids, vals))
        cells, sums = self._sum(torch.cat([c for c, _ in parts]),
                                torch.cat([v for _, v in parts]))
        self.batch_cells.append(int(cells.numel()))
        self.batch_new.append(int((~torch.isin(cells, self.cell)).sum()))
        self.cell, self.sums = self._sum(torch.cat([self.cell, cells]),
                                         torch.cat([self.sums, sums]))

    def _find(self, ids):
        """Rows of ``ids`` in the sorted cell table, -1 where absent."""
        n = self.cell.numel()
        if n == 0:
            return torch.full_like(ids, -1)
        pos = torch.searchsorted(self.cell, ids).clamp(max=n - 1)
        return torch.where(self.cell[pos] == ids, pos,
                           torch.full_like(pos, -1))

    def extract(self) -> dict:
        """The surface cells as float64 / int64 numpy arrays, by cell id,
        with the counts of the work."""
        g, dev = self.geo, self.dev
        s = self.sums.to(F64)
        w = s[:, 0]
        tsdf_all = s[:, 1] / w.clamp(min=1e-9)
        res = [float(r) for r in self.fc["resolution"]]
        gate = self.band * res[0]
        keep = torch.nonzero((w >= self.min_weight)
                             & (tsdf_all.abs() < gate)).squeeze(1)
        cid = self.cell[keep]
        t_here = tsdf_all[keep]
        coords = g.id_coords(cid)
        grads = []
        for a in range(3):
            vals = []
            for sign in (1, -1):
                cc = coords.clone()
                cc[:, a] += sign
                ok = g.valid(cc)
                row = torch.full_like(cid, -1)
                row[ok] = self._find(g.cell_id(cc[ok]))
                has = row >= 0
                vals.append((torch.where(has, tsdf_all[row.clamp(min=0)],
                                         t_here), has))
            (fp, okp), (fm, okm) = vals
            across = (okp.to(F64) + okm.to(F64)) * res[a]
            grads.append((fp - fm) / across.clamp(min=1e-9))
        grad = torch.stack(grads, dim=1)
        gnorm = torch.linalg.vector_norm(grad, dim=1)
        ok = gnorm > 1e-9
        normal = torch.where(ok[:, None], grad / torch.where(
            ok, gnorm, torch.ones_like(gnorm))[:, None],
            torch.cat([grad[:, :2], torch.ones_like(gnorm)[:, None]], 1))
        center = g.center(cid).to(F64)
        out = {
            "cell": cid,
            "centroid": center - t_here[:, None] * normal,
            "normal": normal,
            "mean_dist": t_here,
            "weight": w[keep],
            "count": torch.round(w[keep]).to(torch.int64),
            "rgb": s[keep, 2:5] / s[keep, 5].clamp(min=1.0)[:, None],
        }
        out = {k: v.cpu().numpy() for k, v in out.items()}
        out.update(lanes_valid=self.lanes_valid,
                   batch_cells=list(self.batch_cells),
                   batch_new=list(self.batch_new),
                   unique_cells=int(sum(self.batch_cells)))
        return out


def run_sweep(cfg: dict, frames, device, ftype=torch.float32,
              acc=torch.float64) -> dict:
    """The reference over a whole scan: ``frames`` yields ``(pc, rgb,
    pose)`` tensors in arrival order, integrated in batches of
    ``batch_frames`` frames (the batches only group the work counts; the
    sums do not depend on them).  Returns the extract."""
    K = batch_frames(cfg["fusion_config"])
    ref = TsdfReference(cfg, device, ftype, acc)
    span = []
    for f in frames:
        span.append(f)
        if len(span) == K:
            ref.integrate(span)
            span = []
    if span:
        ref.integrate(span)
    return ref.extract()

