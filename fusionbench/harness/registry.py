"""Find the benchmark's parts by name.

Everything that belongs to one configuration, one traffic mix, one step
kind, one metric or one cell sits in a file of its own, found here by the
name ``BENCHMARK.json`` gives it:

* ``BENCHMARK.json`` (the checkout's root): cells, configurations' files,
  metrics;
* ``fusionbench/traffic/<traffic>.json``: a traffic mix, read by
  ``harness/traffic.py``;
* ``fusionbench/steps/<step>.py``: what one timed cycle does;
* ``fusionbench/e2e/<metric>.py``, ``fusionbench/metrics/<metric>.py``:
  the readers of end-to-end and per-layer metrics;
* ``fusionbench/judge/<model>.py``: the comparison with the plain
  reference for a model family;
* ``fusionbench/limits/<cell>.json``: the limits of a cell's compared
  numbers and the readings they were set from.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(Path(root) / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{_checked(name)}.json")


def limits(cell: str) -> dict:
    return load_json(BENCH_DIR / "limits" / f"{_checked(cell)}.json")


def module(kind: str, name: str):
    """The module ``fusionbench/<kind>/<name>.py``, loaded by its path (a
    metric's name may hold dots)."""
    path = BENCH_DIR / kind / f"{_checked(name)}.py"
    key = f"fusionbench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.exists():
        raise KeyError(f"no {kind} module {name!r} ({path})")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, section: str, cell: str) -> list:
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those without ``workloads`` and those naming it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]
