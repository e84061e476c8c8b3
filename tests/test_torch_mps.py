"""MPS reader/writer and the simplex of the port (``repro_torch.lp.mps``,
``repro_torch.lp.simplex``, numpy copies of the reference's), after
``tests/test_mps.py``: the roundtrip, the port's solver on what the
reader returns, the format corners, and the copies' parses and simplex
optima equal to the reference's."""
import numpy as np
import pytest

from repro_torch.core.pdhg import PDHGOptions, solve_jit
from repro_torch.lp import mps, random_inequality_lp_known, simplex
from repro_torch.lp.generators import lp_known_objective


def test_mps_roundtrip_preserves_problem(tmp_path):
    lp = random_inequality_lp_known(6, 9, seed=0)
    path = str(tmp_path / "t.mps")
    mps.write(lp, path)
    lp2 = mps.read(path)
    np.testing.assert_allclose(lp2.c, lp.c, rtol=1e-12)
    np.testing.assert_allclose(lp2.G, lp.G, rtol=1e-12)
    np.testing.assert_allclose(lp2.h, lp.h, rtol=1e-12)
    np.testing.assert_allclose(lp2.lb, lp.lb)
    np.testing.assert_allclose(lp2.ub, lp.ub)


def test_mps_roundtrip_solves_to_same_optimum(tmp_path):
    lp = random_inequality_lp_known(8, 12, seed=1)
    obj = lp_known_objective(lp)
    path = str(tmp_path / "t.mps")
    mps.write(lp, path)
    lp2 = mps.read(path)
    r = solve_jit(lp2.to_standard(), PDHGOptions(max_iters=30000, tol=1e-6),
                  device="cpu")
    assert abs(r.obj - obj) / abs(obj) < 1e-4


FIXTURE = """* tiny knapsack-ish LP
NAME          TINY
ROWS
 N  COST
 L  CAP
 G  MIN
 E  FIX
COLUMNS
    X0  COST  1.0   CAP  2.0
    X0  MIN   1.0
    X1  COST  -3.0  CAP  1.0
    X1  FIX   1.0
    MARKER1  'MARKER'  'INTORG'
    X2  COST  0.5   CAP  1.0   MIN  1.0
    MARKER2  'MARKER'  'INTEND'
RHS
    RHS  CAP  10.0   MIN  1.0
    RHS  FIX  2.5
BOUNDS
 UP BND  X0  4.0
 BV BND  X2
ENDATA
"""


def test_mps_fixture_parse():
    lp = mps.parse(FIXTURE)
    assert lp.n == 3
    np.testing.assert_allclose(lp.c, [1.0, -3.0, 0.5])
    # L row becomes -row >= -rhs; G row kept
    assert lp.m1 == 2
    assert lp.m2 == 1                  # the E row
    np.testing.assert_allclose(lp.b, [2.5])
    np.testing.assert_allclose(lp.ub, [4.0, np.inf, 1.0])  # BV -> [0,1]
    np.testing.assert_allclose(lp.lb, [0.0, 0.0, 0.0])


def test_mps_fixture_solves():
    """x = (0, 2.5, 1), obj = -7.0 (see tests/test_mps.py), by the port's
    PDHG and by the simplex."""
    lp = mps.parse(FIXTURE)
    r = solve_jit(lp.to_standard(), PDHGOptions(max_iters=30000, tol=1e-7),
                  device="cpu")
    assert abs(r.obj - (-7.0)) < 1e-3
    s = simplex.solve(lp.to_standard())
    assert s.status == "optimal" and abs(s.obj - (-7.0)) < 1e-9


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_copies_match_the_reference(tmp_path, seed):
    """The copies parse the same file into the same problem and the
    simplex reaches the reference's optimum and point."""
    pytest.importorskip("jax")
    from repro.lp import generators as ref_gen
    from repro.lp import mps as ref_mps
    from repro.lp import simplex as ref_simplex

    path = str(tmp_path / "t.mps")
    ref_mps.write(ref_gen.random_inequality_lp_known(7, 10, seed=seed), path)
    a, b = mps.read(path), ref_mps.read(path)
    for f in ("c", "G", "h", "A", "b", "lb", "ub"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    sa = simplex.solve(a.to_standard())
    sb = ref_simplex.solve(b.to_standard())
    assert sa.status == sb.status == "optimal"
    assert sa.obj == sb.obj
    np.testing.assert_array_equal(sa.x, sb.x)
