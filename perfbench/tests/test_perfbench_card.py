"""On the card: every cell of BENCHMARK.json, run by its command
for one short window (a request or two), prints a correct result.  It
skips where no card is visible (decided inside the test)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

import _tiny
from test_perfbench_harness import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the benchmark runs on the card")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "4294967311", "--seconds", "1", "--trace", "1"],
        cwd=_tiny.REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]


def test_run_without_a_card_prints_no_result():
    """Where no card is visible the command fails and prints nothing on
    standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=_tiny.REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2 and proc.stdout == ""
    assert "no CUDA card" in proc.stderr
