"""On the card: a traced run of each cell of BENCHMARK.json reports the
per-layer metrics read from the program's own spans
(``harness/program_spans.py``), each a share in [0, 100].  It skips
where no card is visible (decided inside the test)."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

import _tiny
from test_perfbench_harness import CELLS

SPAN_METRICS = ("stack_share", "prep_share", "host_wait_share",
                "check_share")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cell_reports_its_span_shares(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the benchmark runs on the card")
    want = {m["name"] for m in _tiny.bench()["per_layer"]
            if m["name"].split(".")[0] in SPAN_METRICS
            and cell in m.get("workloads", [])}
    assert want
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "4294967311", "--seconds", "1", "--trace", "1"],
        cwd=_tiny.REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    got = {k: v["value"] for k, v in res["metrics"].items() if k in want}
    assert set(got) == want, res["metrics"]
    assert all(0 <= v <= 100 for v in got.values()), got
