"""The plain reference solves small instances of each configuration's
family to the generator's known optimum, and its judge reads what an
answer says."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import _tiny  # noqa: F401
from perfbench.reference import judge, pdhg
from perfbench.yardstick import generators


@pytest.mark.parametrize("family,m,n,density,seed", [
    ("rand", 24, 48, None, 0), ("rand", 40, 80, None, 5),
    ("sprand", 64, 128, 0.1, 1), ("sprand", 96, 192, 0.05, 2)])
def test_reference_reaches_the_known_optimum(family, m, n, density, seed):
    inst = generators.make(family, m, n, seed, density)
    sol = pdhg.solve(inst, tol=1e-6, max_iters=20000)
    assert sol.status == "optimal"
    r = judge.lp_readings(inst, sol.x, sol.y)
    assert r["obj"] < 1e-5 and r["kkt"] < 1e-5, r


def test_reference_ruiz_matches_the_programs():
    """Both scale the same K to the same diagonals (the same operations
    on the same values)."""
    from repro_torch.core.precondition import ruiz_rescale

    inst = generators.make("rand", 30, 70, 4)
    s = pdhg.prepare(inst, torch.float64, "cpu")
    D1, D2 = ruiz_rescale(torch.as_tensor(inst.K))
    assert torch.equal(s.d1, D1) and torch.equal(s.d2, D2)


def test_judge_reads_missing_and_broken_answers_as_infinite():
    inst = generators.make("rand", 8, 14, 0)
    sol = pdhg.solve(inst, tol=1e-8, max_iters=20000)
    good = judge.lp_readings(inst, sol.x, sol.y)
    assert good["kkt"] < 1e-7 and good["x"] < 1e-5
    for x, y in ((None, sol.y), (sol.x[:-1], sol.y),
                 (np.full_like(sol.x, np.nan), sol.y)):
        assert judge.lp_readings(inst, x, y)["kkt"] == math.inf
    bent = sol.x.copy()
    bent[0] += 1e-3 * np.abs(sol.x).max()
    assert judge.lp_readings(inst, bent, sol.y)["kkt"] > 10 * good["kkt"]
