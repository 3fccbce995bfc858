"""The TSDF family at the ratios of its published configuration against
the plain reference (``fusionbench/reference/tsdf.py``).

``fusionbench/configs/tsdf512-open3d-recon.json`` runs Open3D's
reconstruction-system TSDF: a 3/512 m pitch, a 4 cm truncation (6.83
voxels) and 15 samples a ray.  Here on the CPU at a small size with the
same ratios: a 1 cm pitch, a truncation of 6.83 cm and 15 samples, and a
camera close enough that each cell takes a few hundred sample lanes of a
K-frame batch, on seeded sweeps of the benchmark's generator:

* ``FusionSession(model="tsdf")`` on the depth wire, single-frame and
  K-batched, and on the record wire K-batched (the host decode into the
  planar step), against the reference by cell id: the same surface
  cells, equal weights, and TSDF values, centroids, normals and colours
  to float32 rounding;
* the grid's ``unique_cells`` against the reference's count of the
  distinct cells of each batch, summed;
* on the card (``cuda``), kernel T4 against its plain version at the
  configuration's batch: 8 x 15 x 307,200 = 36.9 M lanes into 60,000
  cells, runs of ~600 lanes across its 512-lane ladder blocks.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fusionbench.harness.traffic import make_inputs
from fusionbench.judge import tsdf as judge
from hifi_fusion_tpu_torch import checks, convert
from hifi_fusion_tpu_torch.config import FusionConfig
from hifi_fusion_tpu_torch.models import tsdf
from hifi_fusion_tpu_torch.runtime.session import FusionSession

RES = 0.01
TAU = RES * 0.04 / (3.0 / 512)          # the configuration's 6.83 voxels
K = 8
CFG = {
    "name": "tsdf-ratios",
    "sensor": {"width": 64, "height": 48, "fx": 300.0, "noise_sd": 3e-4},
    "model": "tsdf",
    "model_params": {"truncation": TAU, "n_samples": 15, "min_weight": 1.0,
                     "surface_band": 1.0, "batch_unique": 1 << 14},
    "fusion_config": {"bbox": [-0.3, 0.3, -0.3, 0.3, 0.0, 0.4],
                      "resolution": [RES] * 3, "z_clip": [0.0, 3.0],
                      "capacity_log2": 14, "max_probes": 64,
                      "max_points": 64 * 48, "max_active_points": 64 * 48,
                      "max_batch_frames": K, "refine_every": 0,
                      "store_color": True},
}
TRAFFIC = {"frames_per_scan": 16, "arc_frames": 40, "wire": "depth",
           "step": "scan", "trace_cycles": 1}


def _fusion_config(cfg):
    return FusionConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in cfg["fusion_config"].items()})


def _session_run(wire, batched, seed):
    """The port's extract and grid metrics after one scan, and the
    reference's over the same sweep with the session's batching."""
    cfg = dict(CFG, fusion_config=dict(CFG["fusion_config"],
                                       max_batch_frames=K if batched else 1))
    inputs = make_inputs(dict(TRAFFIC, wire=wire), cfg, seed, "cpu")
    with FusionSession(_fusion_config(cfg), "cpu", model="tsdf",
                       model_params=cfg["model_params"],
                       batch_fill_wait=5.0 if batched else 0.0) as s:
        s.start()
        inputs.push(s)
        assert s.drain(300)
        m = s.metrics()
        got = {"host": s.pipeline.extract_host(s._grid),
               "grid_metrics": s.pipeline.grid_metrics(s._grid)}
    ref = judge.reference(cfg, inputs, "cpu")
    return got, ref, m


CASES = [("depth", False, 3), ("depth", True, 2 ** 31 + 7),
         ("pc2", True, 11)]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{w}-{'batched' if b else 'single'}"
                     for w, b, _ in CASES])
def run(request):
    return _session_run(*request.param)


def test_lanes_per_cell_cross_ladder_blocks(run):
    """The sweep is the regime the configuration runs: a few hundred
    sample lanes a cell over a K-batch, all in the band."""
    _, ref, m = run
    assert m["frames_integrated"] == 16 and m["dispatch_errors"] == 0
    lanes = TRAFFIC["frames_per_scan"] * 15 * 64 * 48
    assert ref["lanes_valid"] == lanes
    if len(ref["batch_cells"]) == 2:
        assert lanes / sum(ref["batch_cells"]) > 200


def test_surface_matches_reference(run):
    got, ref, m = run
    nums = judge.numbers(got, ref, {"frames_lost": 0,
                                    "dispatch_errors": m["dispatch_errors"]})
    assert got["host"]["cell"].size > 300
    assert nums["overflow"] == 0
    assert nums["cells_symdiff"] == 0 and nums["weight_flips"] == 0
    assert nums["tsdf_gap_um"] < 0.05                 # float32 sums
    assert nums["centroid_gap_um"] < 0.5
    assert nums["normal_off"] == 0 and nums["rgb_off"] == 0
    np.testing.assert_allclose(got["host"]["normal"], ref["normal"],
                               atol=1e-4)


def test_unique_cells_is_the_reference_count(run):
    got, ref, m = run
    assert m["unique_cells"] == got["grid_metrics"]["unique_cells"] \
        == ref["unique_cells"] == sum(ref["batch_cells"]) > 0
    assert m["overflow_unique"] == m["overflow_probe"] == 0
    # every cell the sweep hit was new to some batch
    assert m["occupied_voxels"] == sum(ref["batch_new"])


@pytest.mark.cuda
def test_t4_at_the_configuration_batch():
    """T4 with K2 against its plain version on the card at the
    configuration's batch and U budget: the cell set, ``vstats`` bit for
    bit by cell, and both counters and ``unique_cells`` exactly."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    base = dataclasses.replace(
        _fusion_config(CFG), bbox=(-0.8, 1.8, -1.5, 1.5, 0.0, 1.0),
        resolution=(3.0 / 512,) * 3, capacity_log2=20, max_points=307200,
        max_active_points=307200)
    cfg = tsdf.TsdfConfig(base=base.validate(), truncation=0.04,
                          n_samples=15, min_weight=1.0,
                          batch_unique=1 << 18)
    M, cells, U = K * 15 * 307200, 60000, 1 << 18
    skey, vals6 = (torch.from_numpy(a).to(dev) for a in
                   checks.tsdf_reduce_case(cells, M, seed=20, n_valid=M,
                                           id_range=base.n_cells))
    sid, order = tsdf.sort_lanes(skey)
    out = []
    for fn in (tsdf.tsdf_reduce, tsdf.tsdf_reduce_plain):
        g = tsdf.make_tsdf_grid(cfg, dev)
        fn(g, sid, order, vals6, U, cfg)
        torch.cuda.synchronize()
        out.append((checks.tsdf_by_cell(convert.tsdf_grid_to_numpy(g, cfg),
                                        base.capacity),
                    int(g.unique_cells)))
    (a, ua), (b, ub) = out
    assert np.array_equal(a["cell"], b["cell"]) and a["cell"].size == cells
    assert a["vstats"].tobytes() == b["vstats"].tobytes()
    for k in ("overflow_unique", "overflow_probe"):
        assert a[k] == b[k] == 0, k
    assert ua == ub == cells
