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
  one cell in different hash slots, so every field is keyed by cell id.
* extract parity between two runs (``parity_gates``): the structural gates
  of the JAX package's benchmark parity check (bench.py:723-728), which
  tolerate borderline single-point gate flips but not mass drops.
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
