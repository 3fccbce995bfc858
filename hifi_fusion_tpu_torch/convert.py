"""State carry between the JAX package's grid and the port's.

``grid_from_jax`` takes the JAX ``GridState`` fields as numpy arrays (for
example ``{f: np.asarray(getattr(g, f)) for f in g._fields}``) and strips
the scatter scratch tails; ``grid_to_numpy`` gives the port's state back in
the JAX package's dtypes without tails, and ``grid_to_jax`` with the tails
restored (at their initial values), the JAX package's own shapes.
``tsdf_grid_from_jax`` and ``tsdf_grid_to_numpy`` do the same for the TSDF
family's grid, the second restoring the tails.  With them a test starts
both packages from one state, and a checkpoint (``save_state`` /
``load_state``) written by either package loads in the other.
``sharded_grid_to_jax`` and ``sharded_grid_from_jax`` do the same for a
slab-sharded grid (parallel/sharding.py) in the JAX package's sharded
layout: each shard's fields, tails included, concatenated over the shards
on the leading axis (``buf_pts`` on its lane axis), each scalar an (n,)
array (JAX sharding.py:84-96, :176-179).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .config import FusionConfig
from .grid import SCALAR_FIELDS, GridState
from .models.tsdf import COUNTERS, TsdfGrid, tail


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


# the JAX package's initial value of each per-voxel field (grid.make_grid),
# which its scratch tails hold
_TAIL_FILL = {"key": -1, "occ_bits": 0, "normal_found": False,
              "normal": 0.0, "cyl_stats": 0.0, "viewpoint": 0.0,
              "rgb_sum": 0.0, "n_pts": 0.0, "dep": -1, "dep_count": 0}


def grid_to_jax(grid: GridState, config: FusionConfig
                ) -> Dict[str, np.ndarray]:
    """Port ``GridState`` -> numpy fields in the JAX package's shapes and
    dtypes: ``grid_to_numpy`` with each field's scratch tail appended
    (``scatter_tail`` rows of a per-voxel field's width; ``occ_bits`` as
    many words)."""
    out = grid_to_numpy(grid)
    T = config.scatter_tail
    C = config.capacity
    for name, fill in _TAIL_FILL.items():
        a = out[name]
        k = 1 if name == "occ_bits" else a.shape[0] // C
        out[name] = np.concatenate([a, np.full(k * T, fill, a.dtype)])
    return out


def sharded_grid_to_jax(grids, config: FusionConfig
                        ) -> Dict[str, np.ndarray]:
    """Per-shard port ``GridState``s (shard ``config``) -> numpy fields in
    the JAX package's sharded layout."""
    parts = [grid_to_jax(g, config) for g in grids]
    out = {}
    for f in parts[0]:
        vals = [p[f] for p in parts]
        if f in SCALAR_FIELDS:
            out[f] = np.stack([np.asarray(v).reshape(()) for v in vals])
        else:
            out[f] = np.concatenate(vals, axis=1 if f == "buf_pts" else 0)
    return out


def sharded_grid_from_jax(np_fields: Dict[str, np.ndarray],
                          config: FusionConfig, devices) -> list:
    """Fields in the JAX package's sharded layout -> one port
    ``GridState`` a shard, shard ``j`` on ``devices[j]``."""
    n = len(devices)
    grids = []
    for j, dev in enumerate(devices):
        part = {}
        for f, a in np_fields.items():
            a = np.asarray(a)
            if f in SCALAR_FIELDS:
                part[f] = a.reshape(n)[j]
            else:
                part[f] = np.split(a, n, axis=1 if f == "buf_pts" else 0)[j]
        grids.append(grid_from_jax(part, config, dev))
    return grids


def tsdf_grid_from_jax(np_fields: Dict[str, np.ndarray], config,
                       device) -> TsdfGrid:
    """JAX ``TsdfGrid`` fields (numpy) -> port ``TsdfGrid`` on ``device``:
    ``key`` and ``vstats`` lose their scratch tails; ``unique_cells``,
    which the JAX grid lacks, starts at 0 unless the fields hold it (a
    port checkpoint)."""
    C = config.base.capacity
    out = {"key": np.asarray(np_fields["key"])[:C],
           "vstats": np.asarray(np_fields["vstats"])[:6 * C]}
    out = {f: torch.from_numpy(np.array(a)).to(device)
           for f, a in out.items()}
    for name, dtype in COUNTERS.items():
        out[name] = torch.tensor(int(np_fields.get(name, 0)), dtype=dtype,
                                 device=device)
    return TsdfGrid(**out)


def tsdf_grid_to_numpy(grid: TsdfGrid, config) -> Dict[str, np.ndarray]:
    """Port ``TsdfGrid`` -> numpy fields in the JAX layout, the scratch
    tails restored (``key`` -1, ``vstats`` 0), so the JAX package can take
    the state back; the port's ``unique_cells`` is left out."""
    T = tail(config)
    key = grid.key.detach().cpu().numpy()
    vstats = grid.vstats.detach().cpu().numpy()
    out = {"key": np.concatenate([key, np.full(T, -1, np.int32)]),
           "vstats": np.concatenate([vstats, np.zeros(6 * T, np.float32)])}
    for name in COUNTERS:
        if name != "unique_cells":           # not a field of the JAX grid
            out[name] = getattr(grid, name).detach().cpu().numpy()
    return out

