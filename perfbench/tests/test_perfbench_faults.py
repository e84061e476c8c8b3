"""Each fault a cell can have, planted in the program under a whole run
of a tiny cell on the CPU (the harness's look for a card skipped), makes
``correct`` come out false.  One chip, so no cell has an exchange
between chips to leave out; the dense cell's program solves one LP a
call, so only the stream has a batch to cut in half."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import _tiny  # noqa: F401
from test_perfbench_harness import CELLS, _run


def _unchanged_state(monkeypatch):
    """Every stepped window returns the state it was given."""
    from repro_torch.core import engine

    monkeypatch.setattr(engine.SteppedWindow, "run",
                        lambda self, s, xs, ys: (s, xs, ys))


def _bent(x):
    return 1.5 * np.asarray(x)


def _altered_answer(monkeypatch):
    """Each entry point's answer altered where it is produced: x half
    as large again."""
    from repro_torch.core import pdhg
    from repro_torch.runtime import batch

    solve_jit = pdhg.solve_jit

    def bent_solve(*a, **k):
        res = solve_jit(*a, **k)
        return dataclasses.replace(res, x=_bent(res.x))

    monkeypatch.setattr(pdhg, "solve_jit", bent_solve)
    collect = batch.BatchSolver._collect

    def bent_collect(self, out, bucket, idxs, lps, results):
        collect(self, out, bucket, idxs, lps, results)
        for i in idxs:
            results[i] = dataclasses.replace(results[i],
                                             x=_bent(results[i].x))

    monkeypatch.setattr(batch.BatchSolver, "_collect", bent_collect)


def _half_the_batch(monkeypatch):
    """The stream serves the first half of its LPs and leaves out the
    rest."""
    from repro_torch.runtime import batch

    solve_stream = batch.BatchSolver.solve_stream

    def half(self, lps, draws=None):
        lps = list(lps)
        out = solve_stream(self, lps[:len(lps) // 2], draws)
        return out + [None] * (len(lps) - len(out))

    monkeypatch.setattr(batch.BatchSolver, "solve_stream", half)


FAULTS = {"unchanged_state": (_unchanged_state, CELLS),
          "altered_answer": (_altered_answer, ["dense-exact-tol",
                                               "sparse-stream-tol"]),
          "half_the_batch": (_half_the_batch, ["sparse-stream-tol"])}
CASES = [(f, c) for f, (_, cells) in FAULTS.items() for c in cells
         if c in CELLS]


@pytest.mark.parametrize("fault,cell", CASES)
def test_a_fault_makes_the_run_incorrect(tmp_path, monkeypatch, fault,
                                         cell):
    FAULTS[fault][0](monkeypatch)
    res = _run(tmp_path, cell)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] >= 1
