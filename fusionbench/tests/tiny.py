"""Tiny cells for the CPU tests: each cell of ``BENCHMARK.json`` with its
configuration and traffic cut to a 160 x 120 camera, 16 frames a scan
and a 5 mm grid, so one run takes seconds on the
CPU with the program's plain versions of its kernels."""

from __future__ import annotations

import copy

from fusionbench.harness import registry

W, H, FX, FRAMES = 160, 120, 225.0, 16


def cell(name: str):
    """``(bench, cell, config, traffic, limits)`` of a tiny copy."""
    bench = registry.benchmark()
    c = registry.workload(bench, name)
    cfg = copy.deepcopy(registry.config(bench, c["config"]))
    tr = dict(registry.traffic(c["traffic"]), frames_per_scan=FRAMES,
              trace_cycles=1)
    cfg["sensor"].update(width=W, height=H, fx=FX)
    cfg["fusion_config"].update(resolution=[0.005] * 3, max_points=W * H,
                                max_active_points=W * H, capacity_log2=18)
    return bench, c, cfg, tr, registry.limits(name)


def run(name: str, seed: int = 11, trace: bool = False, patch=None,
        seconds: float = 0.5) -> dict:
    from fusionbench import run as runner
    bench, c, cfg, tr, lim = cell(name)
    return runner.run_cell(bench, c, cfg, tr, lim, seed, seconds, trace,
                           device="cpu", patch=patch)
