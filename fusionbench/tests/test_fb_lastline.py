"""The result line of a run: its keys, its metrics, the checks last."""

import json

import pytest

from fusionbench.harness import registry
from fusionbench.tests import tiny

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_last_line(name, trace):
    r = tiny.run(name, trace=trace)
    r["power_limit"] = "n/a"
    r["checks"] = r.pop("checks")
    line = json.loads(json.dumps(r))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    bench = registry.benchmark()
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in registry.metrics_for(bench, section, name)}
    got = set(line["metrics"])
    assert got <= want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not trace:
        # every end-to-end metric a cell lists is read on the CPU too,
        # but the memory peak, which is the card's
        assert got == want
        assert line["metrics"]["setup_s"]["value"] > 0
    else:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        for c in line["checks"].values():
            assert set(c) == {"value", "limit"}
