"""Comparisons that hold a kernel to its plain version and a run to a
reference, shared by the tests and ``chip_smoke.py``.

Tolerances and their reasons:

* cylinder statistics ``[Σt, Σt², Σd, Σd², hits]``: the hit count is an
  integer-valued f32 below 2^24, so it must match exactly.  The four sums
  may differ in addition order (atomics on the card, ``index_add_`` or
  segmented scans elsewhere) and, against the JAX package, in the rounding
  of each term: XLA on the CPU contracts multiply-adds into FMAs (a cell
  center ``origin + res*(c + 0.5)`` moves by one ulp, ~3e-8 m at 0.3 m).
  Both errors scale with the magnitude of the terms, not of the sum, so
  each sum is held to rtol 1e-5 of a bound on the sum of its terms'
  magnitudes: Σ|t| <= sqrt(hits·Σt²) (Cauchy-Schwarz), Σt², Σd, Σd² as
  they are, each plus hits × the scale of one term's operands (the
  cylinder radius R, or R²).
* grids compared across packages (``by_cell``): the two packages may put
  one cell in different hash slots, so every field is keyed by cell id;
  a kernel held to its plain version (``grid_problems``) is compared the
  same way, K2's CAS race being free to pick other slots, with the
  dependant lists and the buffer also in order.
* extract parity between two runs (``parity_gates``): the structural gates
  of the JAX package's benchmark parity check (bench.py:723-728), which
  tolerate borderline single-point gate flips but not mass drops.
* TSDF grids (``tsdf_grid_problems``), compared by cell id: the key set,
  both overflow counters and ``frames`` exactly; ``vstats`` exactly.  The
  port reproduces the JAX package's sample arithmetic (XLA's fused
  multiply-adds included) and its segmented-scan association order, so
  every per-cell sum is the same f32 value; any difference is a fault.
* segmented scans (``segscan_case`` makes adversarial inputs): bit for bit
  against the JAX package (CPU) or the plain version (card).
* TSDF extracts (``tsdf_extract_problems``): the cell set and the weights
  exactly (they follow from the grid); the TSDF value within 1e-6, the
  centroid within 1e-6 m and the normal within 1e-5 (the tolerances the
  extract gates of the port's tests state: one-ulp differences of the
  gradient arithmetic, should any operation round differently, move a
  normal by ~1e-7 and a centroid by less than the TSDF value's ulp).
"""

from __future__ import annotations

import numpy as np

RTOL = 1e-5


def cyl_stats_error(a, b, radius: float) -> tuple:
    """``(ok, max_abs_err)`` for two (n,5) cylinder-statistics arrays; ``b``
    is the reference, ``radius`` the cylinder radius."""
    a = np.asarray(a, np.float64).reshape(-1, 5)
    b = np.asarray(b, np.float64).reshape(-1, 5)
    if a.shape != b.shape:
        return False, float("inf")
    err = np.abs(a - b)
    hits = b[:, 4]
    mag = np.stack([np.sqrt(hits * np.abs(b[:, 1])) + hits * radius,
                    np.abs(b[:, 1]) + hits * radius ** 2,
                    np.abs(b[:, 2]) + hits * radius,
                    np.abs(b[:, 3]) + hits * radius ** 2], axis=1)
    ok = bool(np.all(a[:, 4] == hits)) and bool(
        np.all(err[:, :4] <= RTOL * mag))
    return ok, float(err.max()) if err.size else 0.0


def parity_gates(a: dict, b: dict, n_frames: int) -> list:
    """Problems (empty when none) between two extract host dicts compared
    by cell id: cell sets sym-diff <= max(8, 0.1%), count mismatches
    <= 25 per frame (and <= 2% of voxels), total cylinder count within
    1e-4 relative."""
    common, ia, ib = np.intersect1d(a["cell"], b["cell"],
                                    return_indices=True)
    n = int(np.asarray(a["cell"]).size)
    sym = (n - common.size) + (int(np.asarray(b["cell"]).size)
                               - common.size)
    problems = []
    if sym > max(8, n // 1000):
        problems.append(f"cell sets diverge: sym_diff {sym} of {n}")
    ca = np.asarray(a["count"], np.int64)[ia]
    cb = np.asarray(b["count"], np.int64)[ib]
    mism = int((ca != cb).sum())
    if mism > max(25 * n_frames, 64) or mism > 0.02 * max(common.size, 1):
        problems.append(f"count mismatch on {mism}/{common.size} voxels")
    rel = abs(int(ca.sum()) - int(cb.sum())) / max(int(cb.sum()), 1)
    if rel > 1e-4:
        problems.append(f"total cylinder-count diff {rel:.2e}")
    return problems


def by_cell(fields: dict, config) -> dict:
    """A grid's fields (numpy, JAX layout, scratch tails allowed) keyed by
    cell id instead of slot: per-cell rows in ascending cell-id order, each
    cell's dependants as its sorted owner cell ids (INT32_MAX padding), the
    live buffer as (cell id, x, y, z) rows sorted lexicographically, and
    ``occ_bits`` (already cell-keyed) and the scalar counters as they are."""
    C, D = config.capacity, config.max_dependants
    key = np.asarray(fields["key"])[:C]
    slots = np.nonzero(key >= 0)[0]
    slots = slots[np.argsort(key[slots], kind="stable")]

    def rows(name, k):
        return np.asarray(fields[name])[:k * C].reshape(C, k)[slots]

    dep = rows("dep", D)
    owner_ids = np.where(dep >= 0, key[np.maximum(dep, 0)],
                         np.iinfo(np.int32).max)
    nb = int(fields["buf_count"])
    bslot = np.asarray(fields["buf_slot"])[:nb]
    bpts = np.asarray(fields["buf_pts"])[:, :nb]
    buf = np.stack([key[bslot].astype(np.float64), bpts[0], bpts[1],
                    bpts[2]], axis=1)
    buf = buf[np.lexsort(buf.T[::-1])]
    out = {
        "cell": key[slots],
        "n_pts": np.asarray(fields["n_pts"])[:C][slots],
        "normal_found": np.asarray(fields["normal_found"])[:C][slots],
        "dep_count": np.asarray(fields["dep_count"])[:C][slots],
        "normal": rows("normal", 3), "cyl_stats": rows("cyl_stats", 5),
        "viewpoint": rows("viewpoint", 3), "rgb_sum": rows("rgb_sum", 3),
        "dep": np.sort(owner_ids, axis=1), "buffer": buf,
        "occ_bits": np.asarray(fields["occ_bits"])[:config.n_occ_words]
        .view(np.uint32),
    }
    for name in ("buf_count", "overflow_probe", "overflow_buf",
                 "overflow_dep", "overflow_refine", "overflow_active",
                 "reclaimed", "frames"):
        out[name] = int(fields[name])
    return out


def ordered_rows(fields: dict, config) -> dict:
    """The order-carrying parts of a grid (numpy fields) keyed by cell id:
    each cell's dependant owners as cell ids in list order (-1 padding),
    in ascending cell-id order, and the live buffer as (cell id, x, y, z)
    rows in buffer order."""
    C, D = config.capacity, config.max_dependants
    key = np.asarray(fields["key"])[:C]
    slots = np.nonzero(key >= 0)[0]
    slots = slots[np.argsort(key[slots], kind="stable")]
    dep = np.asarray(fields["dep"])[:D * C].reshape(C, D)[slots]
    nb = int(fields["buf_count"])
    bslot = np.asarray(fields["buf_slot"])[:nb]
    bpts = np.asarray(fields["buf_pts"])[:, :nb]
    return {"dep": np.where(dep >= 0, key[np.maximum(dep, 0)], -1),
            "buffer": np.stack([key[bslot].astype(np.float64), bpts[0],
                                bpts[1], bpts[2]], axis=1)}


def grid_problems(a: dict, b: dict, config, normal_tol: float = 0.0) -> list:
    """Problems (empty when none) between two grids of the port (numpy
    fields), ``b`` the reference, compared by cell id as a kernel is held
    to its plain version: the cell set, every integer field and counter,
    the occupancy bitmap, the integer-valued rgb and point sums, the
    viewpoints and the dependant lists in order and the buffer in order,
    exactly; normals within ``normal_tol``; cylinder statistics hits
    exactly and sums under ``cyl_stats_error``."""
    ga, gb = by_cell(a, config), by_cell(b, config)
    if not np.array_equal(ga["cell"], gb["cell"]):
        return [f"cell sets differ: {ga['cell'].size} vs "
                f"{gb['cell'].size}, sym_diff "
                f"{np.setxor1d(ga['cell'], gb['cell']).size}"]
    problems = [f"{k}: {ga[k]} != {gb[k]}" for k in
                ("buf_count", "overflow_probe", "overflow_buf",
                 "overflow_dep", "overflow_refine", "overflow_active",
                 "reclaimed", "frames") if ga[k] != gb[k]]
    for f in ("n_pts", "normal_found", "dep_count", "viewpoint", "rgb_sum",
              "occ_bits"):
        if not np.array_equal(ga[f], gb[f]):
            problems.append(f"{f} differs")
    oa, ob = ordered_rows(a, config), ordered_rows(b, config)
    for f in ("dep", "buffer"):
        if oa[f].shape != ob[f].shape or not np.array_equal(oa[f], ob[f]):
            problems.append(f"{f} differs in order")
    err = float(np.abs(ga["normal"] - gb["normal"]).max(initial=0.0))
    if err > normal_tol:
        problems.append(f"normals differ by {err:.3g}")
    ok, err = cyl_stats_error(ga["cyl_stats"], gb["cyl_stats"],
                              config.cylinder_radius)
    if not ok:
        problems.append(f"cyl_stats differ (max abs err {err:.3g})")
    return problems


SEGSCAN_PATTERNS = ("long_runs", "empty_blocks", "late_first", "ragged_tail",
                    "no_flags")


def segscan_case(pattern: str, kind: str, dtype, k: int, n: int,
                 seed: int) -> tuple:
    """Numpy inputs ``(values (k, n), starts (n,) bool)`` for the segmented
    scan whose flags stress the two-level structure (512-lane blocks):

    * ``long_runs``: every segment spans 2-6 blocks;
    * ``empty_blocks``: short runs broken by gaps of 2-5 whole blocks
      without a flag;
    * ``late_first``: no flag in the first third of the lanes;
    * ``ragged_tail``: short runs, then one run from the middle of the
      second-last block through the ragged last one, whose last lane is
      flagged alone;
    * ``no_flags``: one unflagged stretch over everything.

    Values: ``or`` one bit a lane (30% zero); ``int32`` random words;
    ``float32`` normal with 20% -0.0 and 10% +0.0, so that the literal
    zero combines show."""
    rng = np.random.default_rng(seed)
    starts = np.zeros(n, bool)
    if pattern in ("long_runs", "empty_blocks", "ragged_tail"):
        i = 0
        while i < n:
            starts[i] = True
            if pattern == "long_runs":
                i += int(rng.integers(2 * 512, 6 * 512))
            elif pattern == "empty_blocks" and rng.random() < 0.1:
                i += int(rng.integers(2 * 512 + 1, 5 * 512))
            else:
                i += int(rng.integers(1, 41))
        if pattern == "ragged_tail":
            tail = (n // 512 - 1) * 512 + 256
            starts[tail:] = False
            starts[tail] = True
            starts[n - 1] = True
    elif pattern == "late_first":
        i = n // 3
        while i < n:
            starts[i] = True
            i += int(rng.integers(1, 41))
    elif pattern != "no_flags":
        raise ValueError(f"unknown pattern {pattern!r}")
    shape = (k, n)
    if kind == "or":
        vals = (np.int64(1) << rng.integers(0, 31, shape)).astype(np.int32)
        vals[:, rng.random(n) < 0.3] = 0
    elif np.dtype(dtype) == np.int32:
        vals = rng.integers(-2 ** 31, 2 ** 31 - 1, shape, dtype=np.int32)
    else:
        vals = rng.normal(0.0, 3.0, shape).astype(np.float32)
        vals[:, rng.random(n) < 0.2] = np.float32(-0.0)
        vals[:, rng.random(n) < 0.1] = 0.0
    return vals, starts


def tsdf_reduce_case(n_cells: int, M: int, seed: int, n_valid: int = -1,
                     run_lanes: int = 0, id_range: int = 1 << 20) -> tuple:
    """Numpy sample lanes ``(skey (M,) i32, vals6 (6, M) f32)`` for the
    TSDF batch reduce, unsorted as the sample map leaves them:
    ``n_valid`` lanes (default 3/4 of M) in ``n_cells`` distinct cell ids
    drawn from [0, id_range), each on at least one lane, the first on
    ``run_lanes`` lanes more when given (a run across scan tiles); the
    other lanes INT32_MAX with zero values.  Values as the sample map
    makes them: weight 1, sdf normal(0, 3e-3), a colour and its count of
    one on a third of the valid lanes."""
    rng = np.random.default_rng(seed)
    n_valid = 3 * M // 4 if n_valid < 0 else n_valid
    if not n_cells <= n_valid - run_lanes <= M or (n_valid and not n_cells):
        raise ValueError(f"{n_cells} cells on {n_valid} of {M} lanes")
    ids = rng.choice(id_range, n_cells, replace=False).astype(np.int32)
    cell = np.concatenate([
        np.arange(n_cells), np.zeros(run_lanes, np.int64),
        rng.integers(0, max(n_cells, 1), n_valid - n_cells - run_lanes)])
    skey = np.full(M, np.iinfo(np.int32).max, np.int32)
    skey[:n_valid] = ids[cell] if n_cells else skey[:0]
    vals6 = np.zeros((6, M), np.float32)
    vals6[0, :n_valid] = 1.0
    vals6[1, :n_valid] = rng.normal(0.0, 3e-3, n_valid)
    mid = np.zeros(M, bool)
    mid[:n_valid] = rng.random(n_valid) < 1 / 3
    vals6[2:5, mid] = rng.integers(0, 256, (3, int(mid.sum())))
    vals6[5, mid] = 1.0
    perm = rng.permutation(M)
    return skey[perm], np.ascontiguousarray(vals6[:, perm])


TSDF_TOL = {"tsdf": 1e-6, "centroid": 1e-6, "normal": 1e-5}


def tsdf_by_cell(fields: dict, capacity: int) -> dict:
    """A TSDF grid's fields (numpy, JAX layout, scratch tails allowed) keyed
    by cell id: ascending ``cell``, its (n,6) ``vstats`` rows, and the
    counters."""
    key = np.asarray(fields["key"])[:capacity]
    slots = np.nonzero(key >= 0)[0]
    slots = slots[np.argsort(key[slots], kind="stable")]
    out = {"cell": key[slots],
           "vstats": np.asarray(fields["vstats"])[:6 * capacity]
           .reshape(capacity, 6)[slots]}
    for name in ("overflow_probe", "overflow_unique", "frames"):
        out[name] = int(fields[name])
    return out


def tsdf_grid_problems(a: dict, b: dict, capacity: int) -> list:
    """Problems (empty when none) between two TSDF grids' fields (numpy,
    JAX layout) compared by cell id, ``b`` the reference."""
    a, b = tsdf_by_cell(a, capacity), tsdf_by_cell(b, capacity)
    problems = [f"{k}: {a[k]} != {b[k]}" for k in
                ("overflow_probe", "overflow_unique", "frames")
                if a[k] != b[k]]
    if not np.array_equal(a["cell"], b["cell"]):
        problems.append(f"cell sets differ: {a['cell'].size} vs "
                        f"{b['cell'].size} cells, sym_diff "
                        f"{np.setxor1d(a['cell'], b['cell']).size}")
    elif not np.array_equal(a["vstats"], b["vstats"]):
        bad = int((a["vstats"] != b["vstats"]).any(axis=1).sum())
        problems.append(f"vstats differ on {bad} cells")
    return problems


def tsdf_extract_problems(a: dict, b: dict) -> list:
    """Problems (empty when none) between two TSDF extract host dicts
    (``cell``, ``weight``, ``tsdf``, ``centroid``, ``normal``), ``b`` the
    reference, under the tolerances of ``TSDF_TOL``."""
    if not np.array_equal(a["cell"], b["cell"]):
        return [f"cell sets differ: {np.asarray(a['cell']).size} vs "
                f"{np.asarray(b['cell']).size} cells, sym_diff "
                f"{np.setxor1d(a['cell'], b['cell']).size}"]
    problems = []
    if not np.array_equal(a["weight"], b["weight"]):
        problems.append("weights differ")
    for name, tol in TSDF_TOL.items():
        err = float(np.abs(np.asarray(a[name], np.float64)
                           - np.asarray(b[name], np.float64)).max(
            initial=0.0))
        if err > tol:
            problems.append(f"{name} differs by {err:.3g} > {tol}")
    return problems
