#!/usr/bin/env python3
"""The control of the check that decides ``correct``: the plain reference,
put in the program's place and computed one precision below what the
configuration states (bfloat16 geometry and sums for float32), judged
against the reference as a run judges the program.  It prints one JSON
line a seed with the judge's numbers; every limit in
``limits/<cell>.json`` sits below the smallest of them.

    python fusionbench/control.py --workload <cell> --seeds 1,2,3

It runs on the card at the cell's own size; the benchmark's runs do not
run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from fusionbench.harness import registry  # noqa: E402
from fusionbench.harness.traffic import make_inputs  # noqa: E402
from fusionbench.judge import common  # noqa: E402


def as_program(ext: dict) -> dict:
    """A reference extract in the shape of the program's ``process()``
    output."""
    return {"host": dict(ext), "grid_metrics": {}}


def readings(cfg: dict, traffic: dict, seed: int, device,
             ftype=torch.bfloat16) -> dict:
    """The judge's numbers of the control (the reference in ``ftype``)
    against the reference, for one seed."""
    judge = registry.module("judge", cfg["model"])
    inputs = make_inputs(dict(traffic, wire="depth"), cfg, seed, device)
    ref = judge.reference(cfg, inputs, device)
    low = judge.reference(cfg, inputs, device, ftype=ftype, acc=ftype)
    meta = {"frames_lost": 0, "dispatch_errors": 0}
    return judge.numbers(as_program(low), ref, meta)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(argv)
    bench = registry.benchmark()
    cell = registry.workload(bench, a.workload)
    cfg = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    limits = registry.limits(cell["name"])["numbers"]
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.monotonic()
        nums = readings(cfg, traffic, seed, "cuda")
        correct, checks = common.verdict(
            nums, {k: v for k, v in limits.items() if k in nums})
        failed = [k for k, c in checks.items()
                  if not (c["value"] is not None and c["value"] <= c["limit"])]
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "correct": correct, "fails": failed,
                          "numbers": nums,
                          "seconds": time.monotonic() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
