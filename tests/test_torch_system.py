"""The port's own copies of ``test_system``'s end-to-end checks on the
assignment and PageRank LPs: the port's ``solve_jit`` on the CPU, with
its own draws, held to the same ground truth and the same bands."""
import itertools

import numpy as np

from repro_torch.core.pdhg import PDHGOptions, solve_jit
from repro_torch.lp import assignment_lp, pagerank_lp


def _assignment_optimum(lp, n):
    """Brute force over the n! permutations (the LP optimum is integral)."""
    C = lp.c.reshape(n, n)
    return min(sum(C[i, p[i]] for i in range(n))
               for p in itertools.permutations(range(n)))


def test_assignment_lp_integral_solution():
    """Assignment LP optimum is integral (total unimodularity)."""
    lp = assignment_lp(4, seed=0)
    r = solve_jit(lp, PDHGOptions(max_iters=40000, tol=1e-7), device="cpu")
    gt = _assignment_optimum(lp, 4)
    assert abs(r.obj - gt) / abs(gt) < 1e-4
    X = np.asarray(r.x).reshape(4, 4)
    assert np.allclose(X.sum(0), 1, atol=1e-3)
    assert np.allclose(X.sum(1), 1, atol=1e-3)
    assert np.all((X < 1e-2) | (X > 1 - 1e-2))   # integral


def test_pagerank_lp():
    lp = pagerank_lp(64, seed=0)
    r = solve_jit(lp, PDHGOptions(max_iters=40000, tol=1e-7), device="cpu")
    assert r.status == "optimal"
    x = np.asarray(r.x)
    assert abs(x.sum() - 1.0) < 1e-4            # pagerank sums to 1
    assert np.all(x >= -1e-8)
