"""The TSDF batch sort (``models/tsdf.sort_lanes``): kernel T5 on the card,
its plain version (``torch.sort(stable=True)``, the order cast to i32) on
the CPU.

On the CPU: the plain path returns the stable sort's ids and an i32
order, whatever the id range given, T4's wrapper takes that order and
no other, and a grid never sorted on the card counts nothing.

On the card (marked ``cuda``; run there with ``python -m pytest -m cuda
--noconftest tests/test_torch_tsdf_sort.py``): T5's ``(sid, order)``
equals ``torch.sort(skey, stable=True)`` id for id and index for index
on the tsdf512 cell's K=8 batch and on one frame of it (kernel T2's
lanes from the benchmark's sweep), on random ids with fewer than 2^8,
2^16 and 2^24 distinct values, with more than the ranks' inverse holds
(``kernels.SORT_INV_CAP``, so the last pass reads each lane's id) and
with more than 2^24 (ids up to the cell's top cell), on all-invalid
lanes, M = 0, M = 1, a tile's edge and an id range of one bitmap word;
the tables a sort leaves serve the next sort of other ids; its pass
counter reads the passes the distinct-id count needs (2, 3 and 4 on the
random cases); ids outside the grid's range are counted and leave the
in-range lanes' order exact; and T4 on T5's output leaves the grid that
the plain reduce leaves on ``torch.sort``'s i64 order (``vstats`` bit
for bit by cell, the counters and ``unique_cells`` equal).
"""

import dataclasses
import functools
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hifi_fusion_tpu_torch import bounds, checks, convert, kernels
from hifi_fusion_tpu_torch.config import FusionConfig
from hifi_fusion_tpu_torch.models import tsdf

ROOT = Path(__file__).resolve().parent.parent
CELL = ROOT / "fusionbench" / "configs" / "tsdf512-open3d-recon.json"
BIG = tsdf.BIG


def _cell_config():
    cfg = json.loads(CELL.read_text())
    base = FusionConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in cfg["fusion_config"].items()})
    return cfg, tsdf.TsdfConfig(base=base.validate(),
                                **cfg["model_params"])


def _random_ids(M, D, n_cells, n_invalid, seed, device):
    """M lanes: D distinct ids drawn from [0, n_cells) (the top cell
    among them), each on at least one of the M - n_invalid valid lanes,
    and n_invalid INT32_MAX lanes, shuffled."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    ids = torch.randperm(n_cells - 1, generator=g,
                         device=device)[:max(D - 1, 0)]
    ids = torch.cat([ids, torch.full((min(D, 1),), n_cells - 1,
                                     device=device)]).to(torch.int32)
    n_valid = M - n_invalid
    pick = torch.cat([torch.arange(D, device=device),
                      torch.randint(0, max(D, 1), (n_valid - D,),
                                    generator=g, device=device)])
    skey = torch.full((M,), BIG, dtype=torch.int32, device=device)
    if D:
        skey[:n_valid] = ids[pick]
    return skey[torch.randperm(M, generator=g, device=device)].contiguous()


# -- on the CPU: the plain path ---------------------------------------------

@pytest.mark.parametrize("M,D,n_invalid", [
    (5000, 300, 1000), (4097, 4097, 0), (3000, 0, 3000), (1, 1, 0),
    (0, 0, 0)])
def test_plain_sort_is_the_stable_sort_with_an_i32_order(M, D, n_invalid):
    skey = _random_ids(M, D, 1 << 16, n_invalid, seed=M + D, device="cpu")
    want = torch.sort(skey, stable=True)
    for n_cells in (1 << 16, 1):            # the id range is not read here
        sid, order = tsdf.sort_lanes(skey, n_cells)
        assert sid.dtype == order.dtype == torch.int32
        assert torch.equal(sid, want.values)
        assert torch.equal(order.long(), want.indices)
    assert torch.equal(tsdf.sort_lanes_plain(skey)[1], order)


def test_reduce_takes_the_sorts_i32_order_only():
    cfg = tsdf.TsdfConfig(base=_cell_config()[1].base)
    skey, vals6 = (torch.from_numpy(a) for a in
                   checks.tsdf_reduce_case(50, 1000, seed=1, id_range=512))
    sid, order = tsdf.sort_lanes(skey, 512)
    grid = tsdf.make_tsdf_grid(cfg, "cpu")
    with pytest.raises(ValueError, match="order"):
        tsdf.tsdf_reduce(grid, sid, order.long(), vals6, 100, cfg)
    tsdf.tsdf_reduce(grid, sid, order, vals6, 100, cfg)
    assert int(grid.unique_cells) == 50 and int(grid.overflow_unique) == 0


def test_plain_sort_counts_no_pass():
    """The CPU's plain sort makes no tables: a grid integrated there
    counts no batch, pass or lane out of range."""
    tcfg = tsdf.TsdfConfig(base=_cell_config()[1].base)
    pipe = tsdf.TsdfPipeline(tcfg, "cpu")
    grid = pipe.init()
    skey, vals6 = (torch.from_numpy(a) for a in
                   checks.tsdf_reduce_case(50, 1000, seed=1, id_range=512))
    tsdf._reduce(grid, skey, vals6, 1, 100, tcfg)
    assert int(grid.unique_cells) == 50
    assert tsdf.grid_sort_tables(grid, tcfg.base.n_cells) is None
    assert pipe.sort_metrics(grid) == {"sort_batches": 0, "sort_passes": 0,
                                       "sort_lanes_out_of_range": 0}


# -- on the card ------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@functools.cache
def _cell_lanes():
    """Kernel T2's lanes of the tsdf512 cell's first K=8 batch of the
    benchmark's sweep (seed 5) and of its first frame alone, and the
    config."""
    from fusionbench.harness.traffic import make_inputs
    cfg, tcfg = _cell_config()
    K = tcfg.base.max_batch_frames
    traffic = {"frames_per_scan": K, "arc_frames": 100, "wire": "depth",
               "step": "scan", "trace_cycles": 1}
    sweep = make_inputs(traffic, cfg, 5, "cuda").sweep
    pipe = tsdf.TsdfPipeline(tcfg, "cuda")
    N = sweep.n_pixels
    args = (pipe.put(sweep.depth_q), pipe.put(sweep.rgb565),
            pipe.put(np.full((K,), N, np.int32)), pipe.put(sweep.poses),
            pipe.put(sweep.srays))
    batch = tsdf.tsdf_lanes(*args, tcfg)
    frame = tsdf.tsdf_lanes(*(a[:1] for a in args[:4]), args[4], tcfg)
    return tcfg, batch, frame


def _sorted_both(dev, skey, n_cells, tables=None):
    """T5's output, torch.sort's, and the batches, passes and lanes out of
    range T5 counted into ``tables`` (None: tables of its own)."""
    tables = tables or tsdf.SortTables(n_cells, dev)
    before = tables.counts.tolist()
    n0 = kernels.LAUNCHES["tsdf_sort"]
    sid, order = tsdf.sort_lanes(skey, n_cells, tables)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tsdf_sort"] == n0 + 1
    counted = [a - b for a, b in zip(tables.counts.tolist(), before)]
    want = torch.sort(skey, stable=True)
    return (sid, order), want, counted


def _assert_exact(got, want):
    sid, order = got
    assert sid.dtype == order.dtype == torch.int32
    assert torch.equal(sid, want.values)
    assert torch.equal(order.long(), want.indices)


def _distinct(skey):
    return int(torch.unique(skey[skey != BIG]).numel())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["batch", "frame"])
def test_sort_equals_torch_sort_on_the_cells_lanes(dev, shape):
    tcfg, batch, frame = _cell_lanes()
    skey = (batch if shape == "batch" else frame)[0]
    K = tcfg.base.max_batch_frames if shape == "batch" else 1
    assert skey.numel() == K * tcfg.n_samples * 640 * 480
    got, want, counted = _sorted_both(dev, skey, tcfg.base.n_cells)
    _assert_exact(got, want)
    D = _distinct(skey)
    # the sweep's batch falls into a few tens of thousands of cells
    assert 256 <= D < 1 << 16
    assert counted == [1, 2, 0]


# (lanes M, distinct ids D, invalid lanes, id range (0: the cell's
# cells), passes)
RANDOM = {
    "d_under_2_8": (100_000, 200, 5_000, 1 << 20, 1),
    "d_under_2_16": (1_000_000, 30_000, 100_000, 0, 2),
    "d_under_2_24": (2_000_000, 300_000, 200_000, 0, 3),
    "d_over_the_inverse": (6_000_000, kernels.SORT_INV_CAP + 1000, 10_000,
                           0, 3),
    "d_over_2_24": (20_000_000, 17_000_000, 1_000_000, 0, 4),
    "all_invalid": (50_000, 0, 50_000, 0, 1),
    "one_lane": (1, 1, 0, 0, 1),
    "one_invalid_lane": (1, 0, 1, 0, 1),
    "tile_edge": (kernels.SORT_TILE + 1, 3000, 17, 0, 2),
    "id_range_of_one_word": (70_000, 32, 0, 32, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RANDOM))
def test_sort_equals_torch_sort_on_random_ids(dev, case):
    M, D, n_invalid, n_cells, passes = RANDOM[case]
    n_cells = n_cells or _cell_config()[1].base.n_cells
    skey = _random_ids(M, D, n_cells, n_invalid, seed=M + D, device=dev)
    assert _distinct(skey) == D
    got, want, counted = _sorted_both(dev, skey, n_cells)
    _assert_exact(got, want)
    assert bounds.tsdf_sort_passes(D) == passes
    assert counted == [1, passes, 0]


@pytest.mark.cuda
def test_tables_serve_the_next_sort(dev):
    """One grid's tables through sorts of different ids, lane counts and
    pass counts: each sort clears what its mark set, so the next one is
    exact too."""
    n_cells = _cell_config()[1].base.n_cells
    tables = tsdf.SortTables(n_cells, dev)
    zero = kernels.tsdf_sort_tables(n_cells)[1]
    for i, case in enumerate(["d_under_2_16", "d_under_2_24",
                              "d_under_2_8", "d_under_2_16"]):
        M, D, n_invalid, _, passes = RANDOM[case]
        skey = _random_ids(M, D, n_cells, n_invalid, seed=100 + i,
                           device=dev)
        got, want, counted = _sorted_both(dev, skey, n_cells, tables)
        _assert_exact(got, want)
        assert counted == [1, passes, 0]
        assert int(tables.tables[:zero].count_nonzero()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case,passes", [("d_under_2_16", 2),
                                         ("d_under_2_24", 3),
                                         ("d_over_2_24", 4)])
def test_pass_counter_reads_the_passes_d_needs(dev, case, passes):
    M, D, n_invalid, _, _ = RANDOM[case]
    n_cells = _cell_config()[1].base.n_cells
    skey = _random_ids(M, D, n_cells, n_invalid, seed=7, device=dev)
    tables = tsdf.SortTables(n_cells, dev)
    for _ in range(3):
        tsdf.sort_lanes(skey, n_cells, tables)
    assert tables.metrics() == {"sort_batches": 3, "sort_passes": 3 * passes,
                                "sort_lanes_out_of_range": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["past_the_grid", "negative"])
def test_ids_out_of_range_are_counted(dev, bad):
    """Lanes whose id lies outside [0, n_cells) and is not INT32_MAX are
    counted; the in-range lanes come first, in the stable sort's order."""
    n_cells = 1 << 20
    skey = _random_ids(200_000, 5_000, n_cells, 20_000, seed=3, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    pick = torch.randperm(skey.numel(), generator=g, device=dev)[:777]
    skey[pick] = (n_cells + 5 + torch.arange(777, device=dev,
                                             dtype=torch.int32)
                  if bad == "past_the_grid" else -3)
    inside = (skey >= 0) & (skey < n_cells)
    n_in = int(inside.sum())
    tables = tsdf.SortTables(n_cells, dev)
    sid, order = tsdf.sort_lanes(skey, n_cells, tables)
    want = torch.sort(torch.where(inside, skey, BIG), stable=True)
    assert torch.equal(sid[:n_in], want.values[:n_in])
    assert torch.equal(order[:n_in].long(), want.indices[:n_in])
    assert tables.counts.tolist()[::2] == [1, 777]


@pytest.mark.cuda
def test_sort_of_no_lane(dev):
    """M = 0: empty outputs, no launch and nothing counted."""
    skey = torch.empty((0,), dtype=torch.int32, device=dev)
    tables = tsdf.SortTables(1000, dev)
    before = kernels.LAUNCHES["tsdf_sort"]
    sid, order = tsdf.sort_lanes(skey, 1000, tables)
    assert sid.numel() == order.numel() == 0
    assert sid.dtype == order.dtype == torch.int32
    assert kernels.LAUNCHES["tsdf_sort"] == before
    assert tables.counts.tolist() == [0, 0, 0]


@pytest.mark.cuda
def test_reduce_on_the_sort_equals_the_i64_order_path(dev):
    """T4 on T5's ``(sid, order)`` against the reduce on ``torch.sort``'s
    i64 order (the plain version, the path before T5) on the cell's
    batch, into a grid that holds the batch before it: the key set,
    ``vstats`` bit for bit by cell, ``unique_cells`` and both counters."""
    tcfg, (skey, vals6), (skey1, vals1) = _cell_lanes()
    cfg = tcfg.base
    U = min(tcfg.batch_unique, skey.numel(), tsdf.tail(tcfg))
    first = tsdf.make_tsdf_grid(tcfg, dev)
    tsdf.tsdf_reduce(first, *tsdf.sort_lanes(skey1, cfg.n_cells), vals1,
                     U, tcfg)
    out = []
    for path in ("t5", "i64"):
        g = dataclasses.replace(first, **{
            f.name: getattr(first, f.name).clone()
            for f in dataclasses.fields(first)})
        if path == "t5":
            tsdf.tsdf_reduce(g, *tsdf.sort_lanes(skey, cfg.n_cells), vals6,
                             U, tcfg)
        else:
            tsdf.tsdf_reduce_plain(g, *torch.sort(skey, stable=True), vals6,
                                   U, tcfg)
        torch.cuda.synchronize()
        out.append((checks.tsdf_by_cell(convert.tsdf_grid_to_numpy(g, tcfg),
                                        cfg.capacity), int(g.unique_cells)))
    (a, ua), (b, ub) = out
    assert a["cell"].size > 1000 and np.array_equal(a["cell"], b["cell"])
    assert a["vstats"].tobytes() == b["vstats"].tobytes()
    for k in ("overflow_unique", "overflow_probe"):
        assert a[k] == b[k] == 0, k
    assert ua == ub > 0
