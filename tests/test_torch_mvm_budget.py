"""MVM-budget audit of the port: the energy ledger charges
``engine.mvm_accounting``, so the matrix-vector products the port really
issues must match it.  A ``TorchDispatchMode`` counts every aten
matrix-vector and matrix-matrix product on the CPU:

* each check window issues exactly ``mvm_window_budget(check_every,
  restart)``, stepped or through the megakernel's plain version;
* ``step_rule="adaptive"`` adds none over ``"fixed"``;
* the norm estimate issues one per iteration, and a whole ``solve_jit``
  issues ``mvm_calls`` plus the two digital products of its post-hoc
  residual, which the reference does not charge either.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import engine
from repro_torch.core import pdhg as tp
from repro_torch.core.residuals import kkt_residuals
from repro_torch.lp import table1_instance

aten = torch.ops.aten
PRODUCTS = {aten.mv, aten.mm, aten.addmv, aten.addmm, aten.bmm}
CHECK_EVERY = 16
WINDOWS = 4
RULES = {"fixed": 0.0, "adaptive": 0.0, "strongly_convex": 0.05}


class ProductCounter(TorchDispatchMode):
    """Counts aten matrix products dispatched while the mode is active."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in PRODUCTS:
            self.count += 1
        return func(*args, **(kwargs or {}))


def _prepared():
    lp = table1_instance("gen-ip002")
    opts = tp.PDHGOptions(dtype=torch.float64)
    scaled, T, Sigma = tp.prepare(lp, opts, "cpu")
    return scaled, T, Sigma


def _window_counts(rule, restart, megakernel):
    """Products issued in each check window of a ``WINDOWS``-window run
    (tol=0 is never met, so every window runs)."""
    s, T, Sigma = _prepared()
    K, Ka = s.K, s.K.T.contiguous()
    gamma = RULES[rule]
    op = engine.dense_operator(K, Ka)
    if megakernel:
        op = op._replace(fuse=engine.make_fused_dense(
            K, Ka, s.b, s.c, s.lb, s.ub, T, Sigma, gamma))
    g = torch.Generator().manual_seed(0)
    x0, y0 = engine.draw_init(g, K.shape[0], K.shape[1], s.lb, s.ub,
                              K.dtype)
    per_window = 2 if restart else 1      # residual evaluations per check
    marks = []

    with ProductCounter() as counter:
        def residual_fn(x, x_prev, y, Kx, KTy):
            marks.append(counter.count)
            return kkt_residuals(x, x_prev, y, s.c, s.b, Kx, KTy,
                                 lb=s.lb, ub=s.ub).max

        _, _, it, _ = engine.pdhg_loop(
            op, engine.make_updates("cuda"), s.b, s.c, s.lb, s.ub, T, Sigma,
            x0, y0, 0.5, 0.5, max_iters=WINDOWS * CHECK_EVERY, tol=0.0,
            gamma=gamma, check_every=CHECK_EVERY, restart_beta=0.5,
            restart=restart, step_rule=rule, residual_fn=residual_fn)
    assert it == WINDOWS * CHECK_EVERY
    ends = marks[per_window - 1::per_window]
    assert len(ends) == WINDOWS
    return [b - a for a, b in zip([0] + ends[:-1], ends)]


@pytest.mark.parametrize("megakernel", [False, True],
                         ids=["stepped", "megakernel"])
@pytest.mark.parametrize("restart", [True, False],
                         ids=["restart", "norestart"])
@pytest.mark.parametrize("rule", list(RULES))
def test_each_window_issues_its_budget(rule, restart, megakernel):
    counts = _window_counts(rule, restart, megakernel)
    budget = engine.mvm_window_budget(CHECK_EVERY, restart)
    assert budget == 2 * CHECK_EVERY + (4 if restart else 2)
    assert counts == [budget] * WINDOWS


@pytest.mark.parametrize("megakernel", [False, True],
                         ids=["stepped", "megakernel"])
@pytest.mark.parametrize("restart", [True, False],
                         ids=["restart", "norestart"])
def test_adaptive_adds_no_products(restart, megakernel):
    assert (_window_counts("adaptive", restart, megakernel)
            == _window_counts("fixed", restart, megakernel))


@pytest.mark.parametrize("norm_backend", ["lanczos", "power"])
@pytest.mark.parametrize("restart", [True, False],
                         ids=["restart", "norestart"])
def test_solve_issues_what_the_ledger_charges(norm_backend, restart):
    lp = table1_instance("gen-ip002")
    opts = tp.PDHGOptions(max_iters=1000, check_every=CHECK_EVERY,
                          restart=restart, norm_backend=norm_backend)
    with ProductCounter() as counter:
        res = tp.solve_jit(lp, opts, device="cpu")
    assert res.mvm_calls == engine.mvm_accounting(
        res.iterations, CHECK_EVERY, opts.lanczos_iters, restart=restart)
    assert counter.count == res.mvm_calls + 2


def test_norm_estimate_issues_one_product_per_iteration():
    s, T, Sigma = _prepared()
    opts = tp.PDHGOptions(lanczos_iters=23)
    with ProductCounter() as counter:
        tp._norm_estimate(s.K, T, Sigma, opts, None)
    assert counter.count == 23
