"""Configurations, traffic, steps, judges, limits and metrics are found by
the names ``BENCHMARK.json`` gives them, each in a file of its own."""

import pytest

from fusionbench.harness import registry

BENCH = registry.benchmark()


def test_cells_find_their_parts():
    for w in BENCH["workloads"]:
        cfg = registry.config(BENCH, w["config"])
        assert cfg["name"] == w["config"]
        tr = registry.traffic(w["traffic"])
        registry.module("steps", tr["step"])
        registry.module("judge", cfg["model"])
        lim = registry.limits(w["name"])
        assert lim["numbers"]
        for spec in lim["numbers"].values():
            assert spec["limit"] >= 0


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_readers(m):
    mod = registry.module("metrics", m["name"])
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        m["layer"], m["unit"], m["source"], m["moves"])
    assert callable(mod.read)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_readers(m):
    assert callable(registry.module("e2e", m["name"]).read)


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in
               registry.metrics_for(BENCH, "end_to_end", w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert registry.metrics_for(BENCH, "per_layer", w["name"])


def test_config_files_hold_their_reductions():
    for c in BENCH["configs"]:
        cfg = registry.config(BENCH, c["name"])
        assert c["file"].startswith("fusionbench/configs/")
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert cfg["source"] == c["source"]


def test_unknown_names_are_refused():
    with pytest.raises(ValueError):
        registry.traffic("../BENCHMARK")
    with pytest.raises(KeyError):
        registry.module("metrics", "no.such_metric")
