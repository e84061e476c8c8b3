"""MVM-budget audit of the port: the energy ledger charges
``engine.mvm_accounting``, so the matrix-vector products the port really
issues must match it.  A ``TorchDispatchMode`` counts every aten
matrix-vector and matrix-matrix product on the CPU:

* each check window issues exactly ``mvm_window_budget(check_every,
  restart)``, stepped or through the megakernel's plain version (the
  dense megakernel in both forms: a distinct ``K_adj`` and
  ``K_adj=None``), in the single-instance loop and in the batched loop
  (dense, ELL and COO operators over a bucket of lanes), and stepped on
  the crossbar operator (B6's plain version on the symmetric block);
* a refined solve (``crossbar.refine.refined_core``, 1 and 2 rounds)
  runs ``refine_window_factor`` analog loops whose every window issues
  the budget, and issues ``refine_digital_mvms`` exact products outside
  them;
* ``step_rule="adaptive"`` adds none over ``"fixed"``;
* the norm estimate issues one per iteration, and a whole ``solve_jit``
  issues ``mvm_calls`` plus the two digital products of its post-hoc
  residual, which the reference does not charge either; Lanczos adds
  the ``RITZ_PRODUCTS`` (k, k) products of its on-device Ritz value,
  digital work on the tridiagonal matrix (the reference's ``eigvalsh``).
"""
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401  (a fixture)
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import engine
from repro_torch.core import pdhg as tp
from repro_torch.core.lanczos import RITZ_PRODUCTS
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


def _sym_block_operator(K):
    """``engine.crossbar_operator`` on the conductance pair of the
    symmetric block [[0, K], [K^T, 0]] (scale 1, no read noise)."""
    m, n = K.shape
    M = torch.zeros((m + n, m + n), dtype=K.dtype)
    M[:m, m:] = K
    M[m:, :m] = K.T
    return engine.crossbar_operator(torch.clamp(M, min=0.0),
                                    torch.clamp(-M, min=0.0), 1.0, m, n)


def _window_counts(rule, restart, megakernel, kind="dense"):
    """Products issued in each check window of a ``WINDOWS``-window run
    (tol=0 is never met, so every window runs); ``megakernel="kt"`` is
    the megakernel's transpose form (``K_adj=None``)."""
    s, T, Sigma = _prepared()
    K, Ka = s.K, s.K.T.contiguous()
    gamma = RULES[rule]
    op = (engine.dense_operator(K, Ka) if kind == "dense"
          else _sym_block_operator(K))
    if megakernel:
        op = op._replace(fuse=engine.make_fused_dense(
            K, None if megakernel == "kt" else Ka, s.b, s.c, s.lb, s.ub, T,
            Sigma, gamma))
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

        _, _, it, _, windows = engine.drain(engine.pdhg_loop(
            op, engine.make_updates("cuda"), s.b, s.c, s.lb, s.ub, T, Sigma,
            x0, y0, 0.5, 0.5, max_iters=WINDOWS * CHECK_EVERY, tol=0.0,
            gamma=gamma, check_every=CHECK_EVERY, restart_beta=0.5,
            restart=restart, step_rule=rule, residual_fn=residual_fn))
    assert windows == WINDOWS
    assert it.shape == () and int(it) == WINDOWS * CHECK_EVERY
    ends = marks[per_window - 1::per_window]
    assert len(ends) == WINDOWS
    return [b - a for a, b in zip([0] + ends[:-1], ends)]


@pytest.mark.parametrize("megakernel", [False, True, "kt"],
                         ids=["stepped", "megakernel", "megakernel-kt"])
@pytest.mark.parametrize("restart", [True, False],
                         ids=["restart", "norestart"])
@pytest.mark.parametrize("rule", list(RULES))
def test_each_window_issues_its_budget(rule, restart, megakernel):
    counts = _window_counts(rule, restart, megakernel)
    budget = engine.mvm_window_budget(CHECK_EVERY, restart)
    assert budget == 2 * CHECK_EVERY + (4 if restart else 2)
    assert counts == [budget] * WINDOWS


@pytest.mark.parametrize("restart", [True, False],
                         ids=["restart", "norestart"])
@pytest.mark.parametrize("rule", list(RULES))
def test_each_crossbar_window_issues_its_budget(rule, restart):
    counts = _window_counts(rule, restart, False, kind="crossbar")
    assert counts == [engine.mvm_window_budget(CHECK_EVERY, restart)] \
        * WINDOWS


@pytest.mark.parametrize("megakernel", [False, True, "kt"],
                         ids=["stepped", "megakernel", "megakernel-kt"])
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
    ritz = RITZ_PRODUCTS if norm_backend == "lanczos" else 0
    assert counter.count == res.mvm_calls + 2 + ritz


def test_norm_estimate_issues_one_product_per_iteration():
    s, T, Sigma = _prepared()
    opts = tp.PDHGOptions(lanczos_iters=23)
    with ProductCounter() as counter:
        tp._norm_estimate(s.K, T, Sigma, opts, None)
    assert counter.count == 23 + RITZ_PRODUCTS


# ----------------------------------------------------- the batched loop ---

def _batch_window_counts(rule, restart, megakernel, kind):
    """Products issued in each window of the batched loop over a bucket
    of three lanes (a dense stack counted through the aten products; the
    ELL and COO operators counted at their two MVM entry points)."""
    from repro_torch.runtime import batch as tb

    lps = [table1_instance("gen-ip002")] * 3
    B, (m, n) = 3, lps[0].K.shape
    opts = tp.PDHGOptions()
    stacked = tb.stack_problems(lps, m=m, n=n)
    K, b, c, lb, ub = (torch.as_tensor(a) for a in stacked)
    Ks, bs, cs, lbs, ubs, T, Sigma, _, _ = tb.prep_scale(K, b, c, lb, ub,
                                                         opts)
    gamma = RULES[rule]
    if kind in ("dense", "dense-kt"):
        op = engine.dense_operator(Ks, Ks.transpose(1, 2))
        if megakernel:
            op = op._replace(fuse=engine.make_fused_dense(
                Ks, (Ks.transpose(1, 2).contiguous() if kind == "dense"
                     else None), bs, cs, lbs, ubs, T, Sigma, gamma))
    else:
        sp = [lp.sparsified() for lp in lps]
        if kind == "ell":
            df, cf, da, ca = (torch.as_tensor(a) for a in
                              tb.stack_problems_ell(sp, m=m, n=n)[:4])
            op = engine.sparse_ell_operator(df, cf, da, ca)
            if megakernel:
                op = op._replace(fuse=engine.make_fused_ell(
                    df, cf, da, ca, bs, cs, lbs, ubs, T, Sigma, gamma))
        else:
            K_sp = torch.stack([torch.as_tensor(lp.K_dense)
                                for lp in lps]).to_sparse()
            op = engine.sparse_operator(K_sp)
    calls = [0]

    def counted(f):
        def g(v):
            calls[0] += 1
            return f(v)
        return g

    if not kind.startswith("dense"):
        op = op._replace(fwd=counted(op.fwd), adj=counted(op.adj))
        if op.fuse is not None:
            fuse = op.fuse

            def fused(state, n_steps, active):
                calls[0] += 2 * n_steps      # one launch, 2 MVMs a step
                return fuse(state, n_steps, active)
            op = op._replace(fuse=fused)
    g = torch.Generator().manual_seed(0)
    x0 = torch.clamp(torch.randn(B, n, generator=g, dtype=torch.float64),
                     lbs, ubs)
    y0 = torch.randn(B, m, generator=g, dtype=torch.float64)
    per_window = 2 if restart else 1
    marks = []
    with ProductCounter() as counter:
        def residual_fn(x, x_prev, y, Kx, KTy):
            marks.append(counter.count + calls[0])
            return kkt_residuals(x, x_prev, y, cs, bs, Kx, KTy, lb=lbs,
                                 ub=ubs).max

        _, _, its, _, windows = engine.drain(engine.pdhg_loop(
            op, engine.make_updates("cuda"), bs, cs, lbs, ubs, T, Sigma,
            x0, y0, 0.5, 0.5, max_iters=WINDOWS * CHECK_EVERY, tol=0.0,
            gamma=gamma, check_every=CHECK_EVERY, restart_beta=0.5,
            restart=restart, step_rule=rule, residual_fn=residual_fn))
    assert windows == WINDOWS
    assert its.tolist() == [WINDOWS * CHECK_EVERY] * B
    ends = marks[per_window - 1::per_window]
    assert len(ends) == WINDOWS
    return [b - a for a, b in zip([0] + ends[:-1], ends)]


@pytest.mark.parametrize("kind,megakernel", [("dense", False),
                                             ("dense", True),
                                             ("ell", False), ("ell", True),
                                             ("coo", False),
                                             ("dense-kt", True)],
                         ids=["dense", "dense-megakernel", "ell",
                              "ell-megakernel", "coo",
                              "dense-megakernel-kt"])
@pytest.mark.parametrize("restart", [True, False],
                         ids=["restart", "norestart"])
@pytest.mark.parametrize("rule", list(RULES))
def test_each_batched_window_issues_its_budget(rule, restart, megakernel,
                                               kind):
    counts = _batch_window_counts(rule, restart, megakernel, kind)
    assert counts == [engine.mvm_window_budget(CHECK_EVERY, restart)] \
        * WINDOWS


# ------------------------------------------------------ refined solves ---

@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("restart", [True, False],
                         ids=["restart", "norestart"])
def test_refined_solve_issues_its_budget(restart, rounds):
    """``refined_core`` runs ``refine_window_factor(rounds)`` analog loops
    of ``WINDOWS`` windows each, every window issuing the budget on the
    programmed operator, and ``refine_digital_mvms(rounds)`` exact
    products outside them."""
    from repro_torch.crossbar.refine import refined_core

    s, T, Sigma = _prepared()
    K = s.K
    opts = tp.PDHGOptions(max_iters=WINDOWS * CHECK_EVERY, tol=0.0,
                          check_every=CHECK_EVERY, restart=restart,
                          refine_rounds=rounds)
    analog = [0]

    def counted(f):
        def g(v):
            analog[0] += 1
            return f(v)
        return g

    op = engine.dense_operator(K, K.T.contiguous())
    op = op._replace(fwd=counted(op.fwd), adj=counted(op.adj))
    g = torch.Generator().manual_seed(0)
    x0, y0 = engine.draw_init(g, K.shape[0], K.shape[1], s.lb, s.ub,
                              K.dtype)
    marks = []

    def read(flag):
        marks.append(analog[0])
        return bool(flag)

    with ProductCounter() as counter:
        _, _, its, _, windows = engine.drain(refined_core(
            K, K.T, K, K.T, s.b, s.c, s.lb, s.ub, T, Sigma,
            torch.tensor(10.0, dtype=K.dtype), g, tp.opts_static(opts),
            operator=op, x0=x0, y0=y0, read=read))
    factor = engine.refine_window_factor(rounds)
    assert factor == rounds + 1 and engine.refine_window_factor(-1) == 1
    assert windows == [WINDOWS] * factor
    assert [int(i) for i in its] == [WINDOWS * CHECK_EVERY] * factor
    budget = engine.mvm_window_budget(CHECK_EVERY, restart)
    assert [b - a for a, b in zip([0] + marks[:-1], marks)] == \
        [budget] * (WINDOWS * factor)
    assert analog[0] == budget * WINDOWS * factor
    # the analog operator is dense: every product it issues is an aten
    # product too
    assert counter.count - analog[0] == engine.refine_digital_mvms(rounds)
