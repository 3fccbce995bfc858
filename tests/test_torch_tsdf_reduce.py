"""The TSDF batch reduce of the port (``models/tsdf.tsdf_reduce``, whose
CPU path is kernel T4's plain version) against the JAX package's
``_tsdf_reduce`` (models/tsdf.py:135-182) under ``jit``, on seeded sample
lanes (``checks.tsdf_reduce_case``) reduced into a grid that already holds
a first batch: a batch under the U budget, at U + 1 and well over it, an
empty batch, one run over every lane, a table so small that probes
overflow, runs of a few lanes straddling every 512-lane ladder block's
edge, a run of over 1024 lanes that spans a ladder block with no run start
(the summary ladder's carry) and one of ~12 blocks, and batches of at most
1024 lanes (the flat ladder), under and over U.  The grids are compared by
cell id: the key set, both counters and ``frames`` exactly, ``vstats`` bit
for bit.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from hifi_fusion_tpu.config import small_test_config as jax_config
from hifi_fusion_tpu.models import tsdf as jtsdf
from hifi_fusion_tpu_torch import checks, convert
from hifi_fusion_tpu_torch.config import small_test_config
from hifi_fusion_tpu_torch.models import tsdf

KW = dict(refine_every=0, z_clip=(0.05, 10.0))
TINY = dict(KW, capacity_log2=8, max_probes=4)
M, U = 12288, 1000
IDS = 1 << 13                   # the lanes' id range
# (base config, cells of the reduced batch, its valid lanes (-1: 3/4 of
# its lanes), lanes added to its first cell's run, its lanes, its U)
CASES = {
    "under_u": (KW, 700, -1, 0, M, U),
    "u_plus_one": (KW, U + 1, -1, 0, M, U),
    "well_over_u": (KW, 4 * U, -1, 0, M, U),
    "empty": (KW, 0, 0, 0, M, U),
    "one_run": (KW, 1, M, 0, M, U),
    "probe_overflow": (TINY, 400, -1, 0, M, U),
    "block_edges": (KW, 3000, -1, 0, M, 4 * U),
    "run_over_three_blocks": (KW, 300, -1, 2000, M, U),
    "run_over_twelve_blocks": (KW, 200, -1, 6000, M, U),
    "flat": (KW, 500, -1, 0, 1000, 1000),
    "flat_over_u": (KW, 700, -1, 0, 1000, 300),
}


@functools.partial(jax.jit, static_argnums=(3,), static_argnames=("config",))
def _jax_reduce(grid, skey, vals6, U, *, config):
    return jtsdf._tsdf_reduce(grid, skey, vals6, U, config=config)


def _reduce_both(kw, batches):
    """The port's and the JAX package's grids after each ``(skey, vals6,
    U)`` of ``batches`` reduced with budget U; the port's frames counted as
    the JAX package's ``_tsdf_reduce`` counts them (one a call)."""
    cfg = tsdf.TsdfConfig(base=small_test_config(**kw), n_samples=5)
    jcfg = jtsdf.TsdfConfig(base=jax_config(**kw), n_samples=5)
    pg = tsdf.make_tsdf_grid(cfg, "cpu")
    jg = jtsdf.make_tsdf_grid(jcfg)
    for skey, vals6, u in batches:
        tsdf.tsdf_reduce(pg, *tsdf.sort_lanes(torch.from_numpy(skey),
                                              IDS),
                         torch.from_numpy(vals6), u, cfg)
        pg.frames += 1
        jg = _jax_reduce(jg, skey, vals6, u, config=jcfg)
    port = convert.tsdf_grid_to_numpy(pg, cfg)
    ref = {f: np.asarray(getattr(jg, f)) for f in jg._fields}
    return port, ref, cfg.base.capacity


@pytest.mark.parametrize("case", list(CASES))
def test_reduce_matches_jax(case):
    kw, n_cells, n_valid, run, m, u = CASES[case]
    first = checks.tsdf_reduce_case(500, M, seed=1, id_range=IDS)
    batch = checks.tsdf_reduce_case(n_cells, m, seed=2, n_valid=n_valid,
                                    run_lanes=run, id_range=IDS)
    port, ref, C = _reduce_both(kw, [(*first, U), (*batch, u)])
    assert checks.tsdf_grid_problems(port, ref, C) == []
    a, b = checks.tsdf_by_cell(port, C), checks.tsdf_by_cell(ref, C)
    assert a["vstats"].tobytes() == b["vstats"].tobytes()
    over = max(n_cells - u, 0)
    assert a["overflow_unique"] == over
    if case == "probe_overflow":
        assert a["overflow_probe"] > 0
        assert a["cell"].size == int((port["key"][:C] >= 0).sum()) <= C
    else:
        assert a["overflow_probe"] == 0
        # the first batch's 500 cells and the first u of this batch's
        assert a["cell"].size >= min(n_cells, u)
    if run:
        # the long run's cell holds its 1 + run lanes and more
        sid = np.sort(batch[0])
        _, lens = np.unique(sid[sid != tsdf.BIG], return_counts=True)
        assert lens.max() > run > 2 * 512
