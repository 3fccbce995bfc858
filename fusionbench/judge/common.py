"""Comparisons shared by the model families' judges."""

from __future__ import annotations

import numpy as np


def match(a_cell, b_cell):
    """``(common, ia, ib)``: the cells both sides emit and where."""
    return np.intersect1d(np.asarray(a_cell, np.int64),
                          np.asarray(b_cell, np.int64), return_indices=True)


def share(k, n) -> float:
    return float(k) / max(int(n), 1)


def max_or0(x) -> float:
    x = np.asarray(x, np.float64)
    return float(x.max()) if x.size else 0.0


def overflow(grid_metrics: dict) -> int:
    """The program's overflow counters, summed: work it dropped."""
    return int(sum(v for k, v in grid_metrics.items()
                   if k.startswith("overflow")))


def program_counts(meta: dict, grid_metrics: dict) -> dict:
    """Numbers that must be 0 in every sound run: frames the session did
    not integrate, dispatches that failed, overflow counters."""
    return {"frames_lost": int(meta["frames_lost"]),
            "dispatch_errors": int(meta["dispatch_errors"]),
            "overflow": overflow(grid_metrics)}


def verdict(numbers: dict, limits: dict) -> tuple:
    """``(correct, checks)``: every number with a limit must not exceed it;
    ``checks`` maps each compared name to ``{"value", "limit"}``."""
    checks, ok = {}, True
    for name, spec in limits.items():
        v = numbers.get(name)
        lim = float(spec["limit"])
        good = v is not None and np.isfinite(v) and v <= lim
        ok &= bool(good)
        checks[name] = {"value": v, "limit": lim}
    return ok, checks
