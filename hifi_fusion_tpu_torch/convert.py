"""State carry between the JAX package's grid and the port's.

``grid_from_jax`` takes the JAX ``GridState`` fields as numpy arrays (for
example ``{f: np.asarray(getattr(g, f)) for f in g._fields}``) and strips
the scatter scratch tails; ``grid_to_numpy`` gives the port's state back in
the JAX package's dtypes without tails.  With them a test starts both
packages from one state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .config import FusionConfig
from .grid import SCALAR_FIELDS, GridState


def _live_sizes(config: FusionConfig) -> Dict[str, int]:
    C = config.capacity
    return {"key": C, "occ_bits": config.n_occ_words, "normal_found": C,
            "normal": 3 * C, "cyl_stats": 5 * C, "viewpoint": 3 * C,
            "rgb_sum": 3 * C, "n_pts": C,
            "dep": config.max_dependants * C, "dep_count": C}


def grid_from_jax(np_fields: Dict[str, np.ndarray], config: FusionConfig,
                  device) -> GridState:
    """JAX ``GridState`` fields (numpy) -> port ``GridState`` on ``device``."""
    out = {}
    for name, n in _live_sizes(config).items():
        a = np.asarray(np_fields[name])[:n]
        if name == "occ_bits":
            a = np.ascontiguousarray(a, np.uint32).view(np.int32)
        out[name] = torch.from_numpy(np.array(a)).to(device)
    out["buf_pts"] = torch.from_numpy(
        np.array(np_fields["buf_pts"], np.float32)).to(device)
    out["buf_slot"] = torch.from_numpy(
        np.array(np_fields["buf_slot"], np.int32)).to(device)
    for name in SCALAR_FIELDS:
        out[name] = torch.tensor(int(np_fields[name]), dtype=torch.int32,
                                 device=device)
    return GridState(**out)


def grid_to_numpy(grid: GridState) -> Dict[str, np.ndarray]:
    """Port ``GridState`` -> numpy fields in the JAX package's dtypes
    (``occ_bits`` as uint32), without scratch tails."""
    out = {}
    for f in (fld.name for fld in dataclasses.fields(grid)):
        a = getattr(grid, f).detach().cpu().numpy()
        out[f] = a.view(np.uint32) if f == "occ_bits" else a
    return out

