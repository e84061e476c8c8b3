"""The control: the program with its own path one step below the
precision the cell states switched on must come out as not correct.

The LP cells state float64, and the program has a float32 path of its
own (``PDHGOptions.dtype``): that path, TF32 off, is the control.  On
the card it runs at the cell's own size over the cell's whole pool, as
one request, and the judge that a run uses reads it; on the CPU the
dense cell's runs on tiny LPs, beside the program at the cell's own
precision, which the judge passes (the stream's tiny LPs reach 1e-6 in
float32 as well, so its control needs the card's sizes)."""
from __future__ import annotations

import pytest
import torch

import _tiny
from perfbench.harness import runner, spec
from perfbench.tools.readings import served
from test_perfbench_harness import BENCH, CELLS


def _judged(cell, device, dtype):
    entry, out, _ = served(cell, device, dtype=dtype)
    checks, failed = runner.judge(cell, entry, out.answers)
    return all(c["value"] <= c["limit"] for c in checks.values()), failed


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the control runs at the cell's "
                    "own size")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(name, BENCH)
    ok, failed = _judged(cell, torch.device("cuda"), "float32")
    assert not ok and failed >= 1


@pytest.mark.parametrize("dtype,correct", [("float32", False),
                                           ("float64", True)])
def test_control_is_not_correct_on_a_tiny_lp(tmp_path, dtype, correct):
    cell = spec.load_cell("dense-exact-tol", BENCH,
                          _tiny.tiny_data(tmp_path))
    ok, _ = _judged(cell, torch.device("cpu"), dtype)
    assert ok is correct
