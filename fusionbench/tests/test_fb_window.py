"""The window's rate and step arithmetic."""

import pytest

from fusionbench import run as runner
from fusionbench.harness import registry


def rec(**kw):
    base = {"step": "scan", "cycles": 100, "points_per_cycle": 96 * 307200,
            "window_s": 10.5, "setup_s": 20.0, "peak_bytes": 2_000_000_000}
    base.update(kw)
    return base


def test_rate_over_the_whole_window():
    r = registry.module("e2e", "fuse_mpts_s").read(rec())
    assert r == pytest.approx(100 * 96 * 307200 / 10.5 / 1e6)
    assert registry.module("e2e", "fuse_mpts_s").read(
        rec(step="scan_to_file")) is None


def test_time_per_cycle():
    r = registry.module("e2e", "scan_to_file_s").read(
        rec(step="scan_to_file", cycles=25, window_s=30.0))
    assert r == pytest.approx(1.2)
    assert registry.module("e2e", "scan_to_file_s").read(rec()) is None


def test_memory_and_setup():
    assert registry.module("e2e", "peak_device_gb").read(rec()) == 2.0
    assert registry.module("e2e", "setup_s").read(rec()) == 20.0


def test_tenths_of_the_window():
    x = [1.0] * 50 + [2.0] * 50
    assert runner._tenths(x) == [1.0] * 5 + [2.0] * 5
    assert runner._tenths([3.0, 4.0]) == [3.0, 4.0]
