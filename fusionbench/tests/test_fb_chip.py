"""The command as the driver runs it.  Without a card it exits with a code
other than 0 and prints no result; in a directory that holds only the
benchmark it does too.  On the card (``cuda``) one short run of each cell
prints a correct result line."""

import json
import shutil
import subprocess
import sys

import pytest

from fusionbench.harness import registry

ROOT = registry.ROOT
CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


def command(cwd, cell, seconds=2, trace=0):
    return subprocess.run(
        [sys.executable, "fusionbench/run.py", "--workload", cell, "--seed",
         "3000000019", "--seconds", str(seconds), "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=900)


def test_no_result_without_a_card_or_the_program(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    r = command(ROOT, CELLS[0])
    assert r.returncode != 0 and r.stdout == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "fusionbench", tmp_path / "fusionbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = command(tmp_path, CELLS[0])
    assert r.returncode != 0 and r.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card(cell):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = command(ROOT, cell, trace=1)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
