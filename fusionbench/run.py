#!/usr/bin/env python3
"""The benchmark of ``hifi_fusion_tpu_torch``: one cell, one run.

    python fusionbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``configs/*.json``:
the ``FusionConfig`` fields, the model family and its parameters) and a
traffic mix (``traffic/*.json``).  The run:

1. set-up: makes the sweep from ``--seed`` on the card, opens a
   ``FusionSession``, warms the wire the cell uses and runs one untimed
   cycle (``steps/<step>.py``);
2. the window: cycles start while ``--seconds`` remain, and the window
   ends with the last one; the card's peak memory is counted from its
   start;
3. with ``--trace 1``, ``trace_cycles`` more cycles under the profiler
   (``harness/trace.py``);
4. the check: the session hands over the last cycle's output, is closed
   and freed, and the plain reference (``reference/``) works the same
   sweep out on the card; the model family's judge (``judge/<model>.py``)
   compares the two, each number against its limit in
   ``limits/<cell>.json``;
5. the result: the cell's end-to-end metrics (``--trace 0``,
   ``e2e/<name>.py``) or per-layer metrics (``--trace 1``,
   ``metrics/<name>.py``) as one JSON line, last on standard output, with
   the compared numbers last in it and on standard error.

It exits with a code other than 0, printing no result, without a CUDA
card, when the program cannot be imported, and when a module of JAX or
of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def _process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


T_START = time.monotonic() - _process_age_s()
ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fusionbench.harness import guard, host, registry  # noqa: E402
from fusionbench.harness import trace as tracing  # noqa: E402
from fusionbench.harness.traffic import make_inputs  # noqa: E402
from fusionbench.judge import common  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fusion_config(cfg: dict):
    from hifi_fusion_tpu_torch.config import FusionConfig
    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in cfg["fusion_config"].items()}
    return FusionConfig(**fields).validate()


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _timer_diff(after: dict, before: dict) -> dict:
    out = {}
    for name, t in after.items():
        b = before.get(name, {"total_s": 0.0, "count": 0})
        out[name] = {"total_s": t["total_s"] - b["total_s"],
                     "count": t["count"] - b["count"]}
    return out


def _quartiles(x) -> list:
    """Least, quartiles and most of the cycles' seconds."""
    return [float(v) for v in np.quantile(x, [0, 0.25, 0.5, 0.75, 1])] \
        if len(x) else []


def _tenths(x) -> list:
    """The median cycle's seconds in each tenth of the window's cycles."""
    return [float(np.median(p)) for p in np.array_split(x, 10) if len(p)]


def run_cell(bench: dict, cell: dict, cfg: dict, traffic: dict,
             limits: dict, seed: int, seconds: float, trace: bool,
             device="cuda", patch=None) -> dict:
    """One run of ``cell``; the result's fields.  ``patch(session)``, when
    given, is called before the window (the tests plant faults with it)."""
    from hifi_fusion_tpu_torch.runtime.session import (FusionSession,
                                                       batch_frames)
    cuda = torch.device(device).type == "cuda"
    fc = fusion_config(cfg)
    inputs = make_inputs(traffic, cfg, seed, device)
    step = registry.module("steps", traffic["step"])
    tmp = tempfile.mkdtemp(prefix="fusionbench-")
    depth = traffic["wire"] == "depth"
    ctx = {"bytes_written": 0}
    rec = {"step": traffic["step"],
           "points_per_cycle": inputs.points_per_cycle}
    tr = None
    try:
        session = FusionSession(
            fc, device, output_dir=tmp,
            batch_fill_wait=step.BATCH_FILL_WAIT,
            model=cfg["model"], model_params=cfg["model_params"] or None)
        with session:
            session.warm(rays=inputs.sweep.srays if depth else None,
                         depth=depth, planar=not depth)
            step.prepare(session, inputs, ctx)
            step.cycle(session, inputs, ctx)
            if patch is not None:
                patch(session)
            _sync(device)
            before = session.timers.report()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            probe0 = host.probe_ms()
            cpu0 = host.cpu_s()
            t0 = time.monotonic()
            rec["setup_s"] = t0 - T_START
            ends = []
            while time.monotonic() - t0 < seconds:
                step.cycle(session, inputs, ctx)
                ends.append(time.monotonic())
            t1 = ends[-1] if ends else time.monotonic()
            cycles = len(ends)
            rec["host"] = {"cpu_s": host.cpu_s() - cpu0,
                           "probe_ms": [probe0, host.probe_ms()]}
            rec["peak_bytes"] = torch.cuda.max_memory_allocated() \
                if cuda else 0
            timers = _timer_diff(session.timers.report(), before)
            rec.update(window_s=t1 - t0, cycles=cycles,
                       bytes_written=ctx["bytes_written"])
            n_traced = 0
            if trace:
                n_traced = int(traffic["trace_cycles"])

                def traced():
                    for _ in range(n_traced):
                        step.cycle(session, inputs, ctx)

                tr = tracing.Trace(tracing.record(traced, tmp, cuda))
            m = session.metrics()
            expected = (1 + cycles + n_traced) * inputs.frames
            meta = {"frames_lost": expected - m["frames_integrated"]
                    + m["frames_truncated"],
                    "dispatch_errors": m["dispatch_errors"]}
            out = step.finish(session, inputs, ctx)
        batch = batch_frames(fc)
        del session
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    judge = registry.module("judge", cfg["model"])
    t_ref = time.monotonic()
    ref = judge.reference(cfg, inputs, device)
    _sync(device)
    nums = judge.numbers(out, ref, meta)
    correct, checks = common.verdict(nums, limits["numbers"])
    failed = -(-max(meta["frames_lost"], 0) // inputs.frames)
    result = {"correct": correct, "attempted": cycles,
              "failed": min(failed, cycles), "metrics": {}}
    if not trace:
        for m_ in registry.metrics_for(bench, "end_to_end", cell["name"]):
            v = registry.module("e2e", m_["name"]).read(rec)
            if v is not None:
                result["metrics"][m_["name"]] = {"value": v,
                                                 "unit": m_["unit"]}
    else:
        # what a per-layer reader may read: the window's stage timers and
        # counts, the traced cycles, the reference's output (its own
        # counts of the work), the configuration, the mix and the sizes
        lctx = {"timers": timers, "frames": cycles * inputs.frames,
                "cycles": cycles, "trace": tr, "ref": ref, "config": cfg,
                "traffic": traffic, "batch": batch,
                "pixels": inputs.sweep.n_pixels, "trace_cycles": n_traced}
        for m_ in registry.metrics_for(bench, "per_layer", cell["name"]):
            v = registry.module("metrics", m_["name"]).read(lctx)
            if v is not None:
                result["metrics"][m_["name"]] = {"value": v,
                                                 "unit": m_["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(rec["peak_bytes"])}
    if tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["device"] = dev
    result["run"] = {"seed": seed, "cycles": cycles,
                     "window_s": rec["window_s"], "setup_s": rec["setup_s"],
                     "reference_s": time.monotonic() - t_ref,
                     "cycle_s": _quartiles(np.diff([t0] + ends)),
                     "cycle_tenths_s": _tenths(np.diff([t0] + ends)),
                     "host": rec["host"],
                     "bytes_written": rec["bytes_written"],
                     "numbers": nums,
                     "trace": None if tr is None else {
                         "marker_kept": tr.marker_kept,
                         "all_threads": tr.all_threads,
                         "step_ranges": len(tr.named("step"))}}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    a = parse(argv)
    bench = registry.benchmark()
    cell = registry.workload(bench, a.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fusionbench: {a.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cfg = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    limits = registry.limits(cell["name"])
    result = run_cell(bench, cell, cfg, traffic, limits, a.seed, a.seconds,
                      bool(a.trace))
    result["power_limit"] = power_limit()
    result["checks"] = result.pop("checks")         # last in the line
    bad = guard.forbidden_modules()
    if bad:
        print(f"fusionbench: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 3
    print(f"fusionbench: {a.workload} seed {a.seed}: run "
          f"{json.dumps(result['run'])}", file=sys.stderr)
    print(f"correct {result['correct']}; each number and its limit:",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
