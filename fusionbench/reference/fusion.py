"""Plain PyTorch reference of the cylinder-filtered occupancy fusion.

A restatement of the reference node's semantics (REXJJ/high-fidelity-
pointcloud-fusion: ``OccupancyGrid.hpp`` addPoints, updateThicknessVectors
and downloadData; ``pointcloud_fusion_and_filter.cpp``'s clip and
transform), written from that description and imports nothing of the
program.  It runs on any torch device, vectorised over a span of frames,
with no hash table, no kernels and no batching of its own:

* a frame's camera points are clipped to ``z_min < z < z_max``,
  transformed by the pose (``((R0 x + R1 y) + R2 z) + t``, one rounding a
  step), kept strictly inside the bbox, and binned to the cell
  ``floor((p - origin) / res)``; a cell's first point sets the cell's
  viewpoint (that frame's camera position), every point adds to its raw
  count and colour, is kept in the cell's buffer while the cell has no
  normal, and is tested against the cylinder of every owner that lists
  the cell as a dependant;
* a refine pass (after every frame that is a multiple of
  ``refine_every``, shifted by ``refine_first``) takes every occupied cell
  without a normal; one with at least ``min_neighbors`` occupied cells in
  its ``(2k+1)^3`` window gets the smallest-eigenvalue eigenvector of the
  window's occupied offsets (float64 ``eigh``), turned toward its
  viewpoint; the cells its line ``center + (s * res_x) * normal``, ``|s|
  <= line_k`` (each point worked out exactly and rounded once), passes
  through list it as an owner (once a visit), and
  each such cell's buffered points are tested against its cylinder; then
  the buffers of cells with a normal are dropped (``reclaim_buffer``);
* the cylinder test: ``q = p - center``, ``t = q.n``, ``d = |q - t n|``,
  a hit when ``d < radius``; a hit adds ``[t, t^2, d, d^2, 1]``;
* the extract: every occupied cell with a normal, in ascending cell id,
  with ``centroid = center + n * mean(t)``, ``sd = n^2 var(t)``, the mean
  and variance of ``d``, the hit count, the mean colour and the raw count.

``ftype`` is the precision of the geometry (float32 as the node computes
it; bfloat16 for the control), ``acc`` the precision of the sums (float64
here, so the reference's own rounding is far below the program's).
"""

from __future__ import annotations

import math

import torch


def dims_of(bbox, res):
    """Cells along each axis: ``floor((hi - lo) / res)`` (OccupancyGrid.hpp
    xdim_), with a tiny epsilon for exact multiples."""
    return tuple(int(math.floor((bbox[2 * a + 1] - bbox[2 * a]) / res[a]
                                + 1e-9)) for a in range(3))


def refine_marks_due(frames: int, cfg: dict) -> bool:
    """True when a refine pass follows frame number ``frames`` (1-based)."""
    e = int(cfg["refine_every"])
    f0 = int(cfg.get("refine_first", 0))
    if e <= 0:
        return False
    if f0 > 0:
        return frames >= f0 and (frames - f0) % e == 0
    return frames % e == 0


class Geometry:
    """Bbox, cells and centers in one precision."""

    def __init__(self, cfg: dict, device, ftype):
        self.device = torch.device(device)
        self.ftype = ftype
        b = cfg["bbox"]
        self.dims = dims_of(b, cfg["resolution"])
        self.n_cells = self.dims[0] * self.dims[1] * self.dims[2]
        col = dict(dtype=ftype, device=self.device)
        self.origin = torch.tensor([b[0], b[2], b[4]], **col)
        self.hi = torch.tensor([b[1], b[3], b[5]], **col)
        self.res = torch.tensor(cfg["resolution"], **col)
        self.res64 = torch.tensor(cfg["resolution"], dtype=torch.float64,
                                  device=self.device)
        self.origin64 = torch.tensor([b[0], b[2], b[4]], dtype=torch.float64,
                                     device=self.device)
        self.dims_t = torch.tensor(self.dims, dtype=torch.int64,
                                   device=self.device)

    def inside(self, p):
        """(n,3) points strictly inside the bbox."""
        return ((p > self.origin) & (p < self.hi)).all(dim=1)

    def coords(self, p):
        """(n,3) points -> (n,3) int64 cells ``floor((p - origin) / res)``."""
        return torch.floor((p - self.origin) / self.res).to(torch.int64)

    def valid(self, c):
        return ((c >= 0) & (c < self.dims_t)).all(dim=1)

    def cell_id(self, c):
        return (c[:, 0] * self.dims[1] + c[:, 1]) * self.dims[2] + c[:, 2]

    def id_coords(self, cid):
        dz, dy = self.dims[2], self.dims[1]
        return torch.stack([cid // (dy * dz), (cid // dz) % dy, cid % dz],
                           dim=1)

    def center(self, cid):
        """Cell centers ``origin + res (c + 0.5)``, computed in float64 and
        rounded once to ``ftype``."""
        c = self.id_coords(cid).to(torch.float64)
        return (self.origin64 + self.res64 * (c + 0.5)).to(self.ftype)


def transform(pc, pose):
    """(n,3) camera points by a (4,4) pose, ``((R0 x + R1 y) + R2 z) + t``
    in the points' precision."""
    R = pose[:3, :3].to(pc.dtype)
    t = pose[:3, 3].to(pc.dtype)
    x, y, z = pc[:, 0:1], pc[:, 1:2], pc[:, 2:3]
    return ((x * R[:, 0] + y * R[:, 1]) + z * R[:, 2]) + t


def rounded(x64, ftype):
    """A float64 result rounded once to ``ftype``: the exact value of a
    short expression of ``ftype`` operands, as one operation gives it."""
    return x64.to(ftype)


def cylinder(p, c, n):
    """``(t, d)`` of (m,3) points on the axes through ``c`` along ``n``."""
    q = p - c
    t = (q[:, 0] * n[:, 0] + q[:, 1] * n[:, 1]) + q[:, 2] * n[:, 2]
    r = q - t[:, None] * n
    return t, torch.sqrt((r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1])
                         + r[:, 2] * r[:, 2])


def expand(starts, counts):
    """Positions ``starts[i] + j`` for ``j < counts[i]``, and each one's
    ``i``, for (m,) int64 ``starts`` and ``counts``."""
    total = int(counts.sum())
    owner = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts,
        output_size=total)
    first = torch.cumsum(counts, 0) - counts
    pos = starts[owner] + (torch.arange(total, device=counts.device)
                           - first[owner])
    return pos, owner


class FusionReference:
    """The fusion state in compact per-cell arrays, indexed through a dense
    cell-id map."""

    CHUNK = 1 << 21          # points (or pairs) a vectorised block

    def __init__(self, cfg: dict, device, ftype=torch.float32,
                 acc=torch.float64):
        self.cfg = cfg
        self.geo = Geometry(cfg, device, ftype)
        self.dev = self.geo.device
        self.ftype, self.acc = ftype, acc
        self.radius = torch.tensor(cfg["cylinder_radius"], dtype=ftype,
                                   device=self.dev)
        self.idmap = torch.full((self.geo.n_cells,), -1, dtype=torch.int32,
                                device=self.dev)
        self.n = 0
        self._alloc(1 << 16)
        self.link_cell = torch.zeros(0, dtype=torch.int64, device=self.dev)
        self.link_owner = torch.zeros_like(self.link_cell)
        self.buf_cell = torch.zeros_like(self.link_cell)
        self.buf_pts = torch.zeros((0, 3), dtype=ftype, device=self.dev)
        self.frames = 0

    # -- storage -----------------------------------------------------------
    def _alloc(self, cap):
        d, f, a = self.dev, self.ftype, self.acc
        new = {
            "cid": torch.zeros(cap, dtype=torch.int64, device=d),
            "occupied": torch.zeros(cap, dtype=torch.bool, device=d),
            "nf": torch.zeros(cap, dtype=torch.bool, device=d),
            "normal": torch.zeros((cap, 3), dtype=f, device=d),
            "vp": torch.zeros((cap, 3), dtype=f, device=d),
            "npts": torch.zeros(cap, dtype=torch.int64, device=d),
            "rgb": torch.zeros((cap, 3), dtype=a, device=d),
            "stats": torch.zeros((cap, 5), dtype=a, device=d),
        }
        for k, v in new.items():
            old = getattr(self, k, None)
            if old is not None:
                v[:self.n] = old[:self.n]
            setattr(self, k, v)
        self.cap = cap

    def _cells(self, ids):
        """Compact indices of (m,) cell ids, new cells appended."""
        u = torch.unique(ids)
        fresh = u[self.idmap[u] < 0]
        k = fresh.numel()
        if k:
            if self.n + k > self.cap:
                self._alloc(max(2 * self.cap, self.n + k))
            self.cid[self.n:self.n + k] = fresh
            self.idmap[fresh] = torch.arange(self.n, self.n + k,
                                             device=self.dev,
                                             dtype=torch.int32)
            self.n += k
        return self.idmap[ids].long()

    # -- integrate -----------------------------------------------------------
    def points(self, pc, rgb, pose):
        """(n,3) world points, cell ids and colour of one frame's (n,3)
        camera points that pass the clip, the bbox and the grid."""
        g = self.geo
        pc = pc.to(self.ftype)
        z0, z1 = (torch.tensor(z, dtype=self.ftype, device=self.dev)
                  for z in self.cfg["z_clip"])
        keep = (pc[:, 2] > z0) & (pc[:, 2] < z1)
        p = transform(pc[keep], pose.to(self.dev))
        rgb = rgb[keep]
        keep = g.inside(p)
        p, rgb = p[keep], rgb[keep]
        c = g.coords(p)
        keep = g.valid(c)
        return p[keep], g.cell_id(c[keep]), rgb[keep]

    def integrate(self, frames):
        """A span of frames between two refine marks: ``[(pc (n,3), rgb
        (n,3), pose (4,4)), ...]`` in arrival order."""
        pts, ids, cols, fidx = [], [], [], []
        for i, (pc, rgb, pose) in enumerate(frames):
            p, cid, col = self.points(pc, rgb, pose)
            pts.append(p)
            ids.append(cid)
            cols.append(col)
            fidx.append(torch.full_like(cid, i))
        p = torch.cat(pts)
        c = self._cells(torch.cat(ids))
        col = torch.cat(cols).to(self.acc)
        fi = torch.cat(fidx)
        nf_before = self.nf[c]
        # raw count and colour
        self.npts.index_add_(0, c, torch.ones_like(c))
        if self.cfg.get("store_color", True):
            self.rgb.index_add_(0, c, col)
        # the viewpoint of a cell's first point
        first = torch.full((self.n,), len(frames), dtype=torch.int64,
                           device=self.dev)
        first.scatter_reduce_(0, c, fi, reduce="amin")
        newly = (~self.occupied[:self.n]) & (first < len(frames))
        cam = torch.stack([f[2][:3, 3] for f in frames]).to(
            self.dev, self.ftype)
        self.vp[:self.n][newly] = cam[first[newly]]
        self.occupied[:self.n] |= newly
        # the stream through the owners registered so far
        self._stream(p, c)
        # the buffer of cells still without a normal
        keep = ~nf_before
        self.buf_cell = torch.cat([self.buf_cell, c[keep]])
        self.buf_pts = torch.cat([self.buf_pts, p[keep]])
        self.frames += len(frames)

    def _link_table(self):
        """Per compact cell: the first link and the number of links, links
        sorted by their cell."""
        order = torch.argsort(self.link_cell, stable=True)
        self.link_cell = self.link_cell[order]
        self.link_owner = self.link_owner[order]
        counts = torch.bincount(self.link_cell, minlength=self.n)
        starts = torch.cumsum(counts, 0) - counts
        return starts, counts

    def _stream(self, p, c):
        if not self.link_cell.numel():
            return
        starts, counts = self._link_table()
        for a in range(0, c.numel(), self.CHUNK):
            cc = c[a:a + self.CHUNK]
            pos, i = expand(starts[cc], counts[cc])
            self._hits(p[a:a + self.CHUNK][i], self.link_owner[pos])

    def _hits(self, p, owner):
        """Add the cylinder statistics of points ``p`` to ``owner``."""
        for a in range(0, owner.numel(), self.CHUNK):
            o = owner[a:a + self.CHUNK]
            t, d = cylinder(p[a:a + self.CHUNK], self.geo.center(self.cid[o]),
                            self.normal[o])
            hit = d < self.radius
            t, d, o = t[hit].to(self.acc), d[hit].to(self.acc), o[hit]
            self.stats.index_add_(0, o, torch.stack(
                [t, t * t, d, d * d, torch.ones_like(t)], dim=1))

    # -- refine --------------------------------------------------------------
    def _window_offsets(self):
        k = int(self.cfg["k_neighborhood"])
        r = torch.arange(-k, k + 1, device=self.dev)
        return torch.cartesian_prod(r, r, r)                     # (M,3)

    def refine(self):
        g = self.geo
        cand = torch.nonzero(self.occupied[:self.n] & ~self.nf[:self.n]
                             ).squeeze(1)
        offs = self._window_offsets()
        offs_m = offs.to(torch.float64) * g.res64
        outer = (offs_m[:, :, None] * offs_m[:, None, :]).reshape(-1, 9)
        normals, gated = [], []
        step = max(1, self.CHUNK // offs.shape[0])
        for a in range(0, cand.numel(), step):
            u = cand[a:a + step]
            nc = g.id_coords(self.cid[u])[:, None, :] + offs[None]  # (U,M,3)
            ok = g.valid(nc.reshape(-1, 3)).reshape(nc.shape[:2])
            nid = torch.where(ok, g.cell_id(nc.reshape(-1, 3)).reshape(
                ok.shape), torch.zeros_like(ok, dtype=torch.int64))
            slot = self.idmap[nid].long()
            occ = (ok & (slot >= 0)
                   & self.occupied[slot.clamp(min=0)]).to(torch.float64)
            total = occ.sum(dim=1)
            gate = total >= int(self.cfg["min_neighbors"])
            tot = total.clamp(min=1.0)[:, None]
            mean = occ @ offs_m / tot
            cov = (occ @ outer / tot).reshape(-1, 3, 3) \
                - mean[:, :, None] * mean[:, None, :]
            _, vec = torch.linalg.eigh(cov)
            n = vec[:, :, 0].to(self.ftype)
            center = g.center(self.cid[u])
            dv = (self.vp[u] - center).to(torch.float64)
            flip = (dv * n.to(torch.float64)).sum(dim=1) < 0
            normals.append(torch.where(flip[:, None], -n, n))
            gated.append(gate)
        if not cand.numel():
            return
        n = torch.cat(normals)
        gate = torch.cat(gated)
        owners = cand[gate]
        n = n[gate]
        self.normal[owners] = n
        self.nf[owners] = True
        self._register(owners, n)
        if self.cfg.get("reclaim_buffer", True):
            keep = ~self.nf[self.buf_cell]
            self.buf_cell = self.buf_cell[keep]
            self.buf_pts = self.buf_pts[keep]

    def _register(self, owners, n):
        """The line cells of each new owner list it (once a visit), and
        their buffered points meet its cylinder."""
        g = self.geo
        K = int(self.cfg["line_k"])
        center = g.center(self.cid[owners])
        res0 = g.res[0]
        lcell, lown = [], []
        for s in range(-K, K + 1):
            step = torch.tensor(float(s), dtype=self.ftype,
                                device=self.dev) * res0
            pos = rounded(center.double() + step.double() * n.double(),
                          self.ftype)
            c = g.coords(pos)
            ok = g.inside(pos) & g.valid(c)
            lcell.append(g.cell_id(c[ok]))
            lown.append(owners[ok])
        lcell = torch.cat(lcell)
        lown = torch.cat(lown)
        if not lcell.numel():
            return
        lc = self._cells(lcell)
        self.link_cell = torch.cat([self.link_cell, lc])
        self.link_owner = torch.cat([self.link_owner, lown])
        # the replay: each new link meets its cell's buffered points
        order = torch.argsort(self.buf_cell, stable=True)
        bcell, bpts = self.buf_cell[order], self.buf_pts[order]
        counts = torch.bincount(bcell, minlength=self.n)
        starts = torch.cumsum(counts, 0) - counts
        for a in range(0, lc.numel(), max(1, self.CHUNK // 8)):
            cc = lc[a:a + self.CHUNK // 8]
            pos, i = expand(starts[cc], counts[cc])
            self._hits(bpts[pos], lown[a:a + self.CHUNK // 8][i])

    # -- extract -------------------------------------------------------------
    def extract(self) -> dict:
        """The emitted cells as float64 / int64 numpy arrays, by cell id."""
        keep = torch.nonzero(self.occupied[:self.n] & self.nf[:self.n]
                             ).squeeze(1)
        keep = keep[torch.argsort(self.cid[keep])]
        cid = self.cid[keep]
        center = self.geo.center(cid).to(torch.float64)
        n = self.normal[keep].to(torch.float64)
        st = self.stats[keep].to(torch.float64)
        cnt = st[:, 4]
        has = cnt > 0
        c1 = cnt.clamp(min=1.0)
        mt = st[:, 0] / c1
        var_t = st[:, 1] / c1 - mt * mt
        md = st[:, 2] / c1
        zero = torch.zeros((), dtype=torch.float64, device=self.dev)
        npts = self.npts[keep]
        out = {
            "cell": cid,
            "centroid": torch.where(has[:, None], center + n * mt[:, None],
                                    zero),
            "normal": n,
            "sd": torch.where(has[:, None], n * n * var_t[:, None], zero),
            "mean_dist": torch.where(has, md, zero),
            "sd_dist": torch.where(has, st[:, 3] / c1 - md * md, zero),
            "count": torch.round(cnt).to(torch.int64),
            "rgb": self.rgb[keep].to(torch.float64)
            / npts.clamp(min=1)[:, None].to(torch.float64),
            "n_pts": npts,
        }
        return {k: v.cpu().numpy() for k, v in out.items()}


def run_sweep(cfg: dict, frames, device, ftype=torch.float32,
              acc=torch.float64) -> dict:
    """The reference over a whole scan: ``frames`` yields ``(pc, rgb,
    pose)`` tensors in arrival order; refine after each mark, and once at
    the end when the last frame is not a mark (``process()``'s final
    refine).  Returns the extract."""
    ref = FusionReference(cfg, device, ftype, acc)
    span = []
    for f in frames:
        span.append(f)
        if refine_marks_due(ref.frames + len(span), cfg):
            ref.integrate(span)
            span = []
            ref.refine()
    if span:
        ref.integrate(span)
    if ref.frames and not refine_marks_due(ref.frames, cfg):
        ref.refine()
    return ref.extract()
