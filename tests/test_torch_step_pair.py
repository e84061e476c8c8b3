"""The stepped window's step pair: ``schedule`` once a window, then
``dual_step`` and ``primal_step`` a step (``kernels.pdhg_update``), run by
``engine.SteppedWindow``.

On the CPU: a window of the plain step pair against the stepped window
it replaces (``engine.pdhg_step`` on the plain updates, the θ of the
step, and the sums ``xs + x``, ``ys + y``), bit for bit in x, x_prev,
x_bar, y, τ, σ and both sums, for one instance and a batch, under the
``fixed`` and ``strongly_convex`` rules; the plain schedule's layout; the
wrappers' rule that only a CPU tensor takes the plain version.  The
JAX parity of the whole loop is in ``test_torch_engine.py``,
``test_torch_solve.py``, ``test_torch_batch.py`` and
``test_torch_sparse.py``.  On a card (``cuda`` marker, skipped without
one): each step kernel against its plain version in f64 and f32, and a
stepped solve run as a CUDA graph against the same solve run eagerly:
equal iterations, bit-identical x and equal launch counts.
"""
from functools import partial

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import engine
from repro_torch.kernels import pdhg_update as tupd

GAMMAS = {"fixed": 0.0, "strongly_convex": 0.05}
STATE = ("x", "x_prev", "x_bar", "y", "tau", "sigma")


def _problem(seed, lead, m, n, dtype=torch.float64, dev="cpu"):
    """A well-posed window: K ~ N(0, 1/n), a mix of finite, half-infinite
    and free bounds, a start inside them, per-lane steps and nonzero
    running sums."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    def vec(d, lo=-1.0, hi=1.0):
        return t(rng.uniform(lo, hi, (*lead, d)))

    K = t(rng.normal(size=(*lead, m, n)) / np.sqrt(n))
    kind = rng.integers(0, 3, (*lead, n))
    lb = t(np.where(kind == 0, -0.5, np.where(kind == 1, 0.0, -np.inf)))
    ub = t(np.where(kind == 0, 0.5, np.inf))
    x = torch.clamp(vec(n), lb, ub)
    steps = t(rng.uniform(0.2, 0.4, lead))
    state = engine.PDHGState(x=x, x_prev=x.clone(), x_bar=x.clone(),
                             y=vec(m), tau=steps, sigma=steps * 1.1)
    vecs = dict(b=vec(m), c=vec(n), lb=lb, ub=ub, T=vec(n, 0.5, 1.0),
                Sigma=vec(m, 0.5, 1.0))
    return K, vecs, state, vec(n), vec(m)


def _old_window(op, upd, vecs, gamma, state, xs, ys, n_steps):
    """The stepped window before the step pair: ``pdhg_step`` a step,
    with its θ, and the sums' one add an element."""
    s = state
    for _ in range(n_steps):
        s = engine.pdhg_step(op, upd, *vecs.values(), gamma, s)
        xs, ys = xs + s.x, ys + s.y
    return s, xs, ys


@pytest.mark.parametrize("upd", ["torch", "cuda"])
@pytest.mark.parametrize("lead", [(), (3,)], ids=["single", "batch3"])
@pytest.mark.parametrize("rule", list(GAMMAS))
def test_plain_step_pair_window_is_bit_identical_to_pdhg_steps(rule, lead,
                                                               upd):
    gamma = GAMMAS[rule]
    K, vecs, state, xs, ys = _problem(3, lead, 9, 14)
    op = engine.dense_operator(K, K.mT)
    updates = engine.make_updates(upd)
    kernels.reset_launch_counts()
    old = _old_window(op, updates, vecs, gamma, state, xs, ys, 17)
    window = engine.SteppedWindow(op, updates, *vecs.values(), gamma, 17,
                                  state.x, state.y, capture=False)
    new = window.run(state, xs, ys)
    for k in STATE:
        assert torch.equal(getattr(new[0], k), getattr(old[0], k)), k
    assert torch.equal(new[1], old[1]) and torch.equal(new[2], old[2])
    # a second window from the first one's output, through the same
    # buffers
    old2 = _old_window(op, updates, vecs, gamma, *old, 17)
    new2 = window.run(engine.PDHGState(*(t.clone() for t in new[0])),
                      new[1].clone(), new[2].clone())
    for k in STATE:
        assert torch.equal(getattr(new2[0], k), getattr(old2[0], k)), k
    assert torch.equal(new2[1], old2[1]) and torch.equal(new2[2], old2[2])
    # the plain versions are not launches
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("lead", [(), (2,)], ids=["single", "batch2"])
def test_plain_schedule_writes_the_loops_theta_schedule(lead):
    tau = torch.tensor([0.3, 0.2] if lead else 0.3, dtype=torch.float64)
    sigma = tau * 1.5
    sched, tau_out, sigma_out = tupd.schedule_plain(tau, sigma, 5, 0.05)
    assert sched.shape == (3, 5, *lead)
    t, s = tau, sigma
    for k in range(5):
        theta = 1.0 / torch.sqrt(1.0 + 2.0 * 0.05 * t)
        assert torch.equal(sched[0, k], t)
        assert torch.equal(sched[1, k], s)
        assert torch.equal(sched[2, k], theta)
        t, s = theta * t, s / theta
    assert torch.equal(tau_out, t) and torch.equal(sigma_out, s)
    # the fixed rule: theta 1, the steps unchanged
    sched, tau_out, sigma_out = tupd.schedule_plain(tau, sigma, 4, 0.0)
    assert bool((sched[2] == 1.0).all())
    assert torch.equal(tau_out, tau) and torch.equal(sigma_out, sigma)


def test_step_wrappers_take_plain_versions_only_for_cpu_tensors():
    _, vecs, state, xs, ys = _problem(5, (), 6, 10)
    kxbar, kty = torch.ones(6, dtype=torch.float64), torch.ones(
        10, dtype=torch.float64)
    kernels.reset_launch_counts()
    out = tupd.dual_step(state.y, kxbar, vecs["b"], vecs["Sigma"],
                         state.sigma, ys.clone())
    assert torch.equal(out, tupd.dual_update_plain(
        state.y, kxbar, vecs["b"], vecs["Sigma"], state.sigma))
    xs_new = xs.clone()
    theta = torch.tensor(0.9, dtype=torch.float64)
    x_new, x_bar = tupd.primal_step(state.x, kty, vecs["c"], vecs["T"],
                                    vecs["lb"], vecs["ub"], state.tau,
                                    theta, xs_new)
    ref = tupd.primal_update_plain(state.x, kty, vecs["c"], vecs["T"],
                                   vecs["lb"], vecs["ub"], state.tau, theta)
    assert torch.equal(x_new, ref[0]) and torch.equal(x_bar, ref[1])
    assert torch.equal(xs_new, xs + ref[0])
    tupd.schedule(state.tau, state.sigma, 3, 0.0)
    assert not any(kernels.launch_counts().values())


def test_window_needs_the_step_forms():
    # an update backend is not whole without the forms the window runs
    with pytest.raises(TypeError, match="schedule"):
        engine.Updates(tupd.primal_update_plain, tupd.dual_update_plain,
                       "torch")
    for upd in (engine.TORCH_UPDATES, engine.CUDA_UPDATES):
        assert all(callable(getattr(upd, f))
                   for f in ("schedule", "dual_step", "primal_step"))


def test_only_noiseless_device_operators_may_be_captured():
    K = torch.eye(3, dtype=torch.float64)
    g = torch.Generator().manual_seed(0)
    assert engine.dense_operator(K, K.mT).capture
    assert not engine.dense_operator(K, K.mT, 0.05, g).capture
    assert engine.sparse_operator(K.to_sparse()).capture
    assert not engine.sparse_operator(K.to_sparse(), 0.05, g).capture


# ------------------------------------------------------------ on a card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(outs, refs):
    """Largest error of an output over that output's own largest |value|."""
    return max(float((o - r).abs().max()) / max(float(r.abs().max()), 1e-300)
               for o, r in zip(outs, refs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-14),
                                       (torch.float32, 1e-6)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("lead,m,n", [((), 37, 4101), ((3,), 133, 217)],
                         ids=["single", "batch3"])
def test_step_kernels_match_plain_on_card(cuda, dtype, tol, lead, m, n):
    _, vecs, state, xs, ys = _problem(7, lead, m, n, dtype, cuda)
    kx = torch.rand(*lead, m, device=cuda, dtype=dtype)
    kty = torch.rand(*lead, n, device=cuda, dtype=dtype)
    kernels.reset_launch_counts()
    sched = tupd.schedule(state.tau, state.sigma, 7, 0.05)
    sched_ref = tupd.schedule_plain(state.tau, state.sigma, 7, 0.05)
    assert _rel(sched, sched_ref) <= tol
    ys_k, ys_p = ys.clone(), ys.clone()
    y_k = tupd.dual_step(state.y, kx, vecs["b"], vecs["Sigma"],
                         sched[0][1, 3], ys_k)
    y_p = tupd.dual_step_plain(state.y, kx, vecs["b"], vecs["Sigma"],
                               sched[0][1, 3], ys_p)
    assert _rel([y_k, ys_k], [y_p, ys_p]) <= tol
    xs_k, xs_p = xs.clone(), xs.clone()
    outs = tupd.primal_step(state.x, kty, vecs["c"], vecs["T"], vecs["lb"],
                            vecs["ub"], sched[0][0, 3], sched[0][2, 3],
                            xs_k)
    refs = tupd.primal_step_plain(state.x, kty, vecs["c"], vecs["T"],
                                  vecs["lb"], vecs["ub"], sched[0][0, 3],
                                  sched[0][2, 3], xs_p)
    assert _rel([*outs, xs_k], [*refs, xs_p]) <= tol
    # one IEEE add an element: the sum is exactly ys + y_new
    assert torch.equal(ys_k, ys + y_k) and torch.equal(xs_k, xs + outs[0])
    with pytest.raises(ValueError, match="alias"):
        tupd.dual_step(state.y, kx, vecs["b"], vecs["Sigma"],
                       sched[0][1, 3], ys_k, out=ys_k)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert (counts["schedule"], counts["dual_step"],
            counts["primal_step"]) == (1, 1, 1)
    assert sum(counts.values()) == 3


@pytest.mark.cuda
def test_captured_stepped_solve_equals_eager_on_card(cuda, monkeypatch):
    """One dense stepped solve as a CUDA graph a window and the same
    solve with every window eager: the same iterations, the same x bit
    for bit, and the same launch counts."""
    from repro_torch.core.pdhg import PDHGOptions, solve_jit
    from repro_torch.lp import random_standard_lp

    lp = random_standard_lp(60, 110, seed=4)
    opts = PDHGOptions(max_iters=6000, tol=1e-6, check_every=50)
    runs = {}
    for graph in (True, False):
        kernels.reset_launch_counts()
        engine.GRAPHS.update(captures=0, replays=0)
        with monkeypatch.context() as mp:
            # the engine's switch, reached through the solve core
            mp.setattr(engine, "solve_core",
                       partial(engine.solve_core, graph=graph))
            res = solve_jit(lp, opts, device=cuda)
        runs[graph] = (res, kernels.launch_counts(), dict(engine.GRAPHS))
    (ra, ca, ga), (rb, cb, gb) = runs[True], runs[False]
    windows = ra.iterations // opts.check_every
    assert windows >= 3
    assert ra.iterations == rb.iterations and ra.status == rb.status
    assert np.array_equal(ra.x, rb.x) and np.array_equal(ra.y, rb.y)
    assert ca == cb
    assert ca["dual_step"] == ca["primal_step"] == ra.iterations
    assert ca["schedule"] == windows and ca["dual_update"] == 0
    assert ga == {"captures": 1, "replays": windows - 1}
    assert gb == {"captures": 0, "replays": 0}


@pytest.mark.cuda
def test_repeated_captured_solves_hold_no_more_memory_on_card(cuda):
    """Solves on the default stream share one capture stream: a second
    and a third solve leave the card's allocated memory where the first
    left it (a new stream each would keep one more cuBLAS workspace)."""
    from repro_torch.core.pdhg import PDHGOptions, solve_jit
    from repro_torch.lp import random_standard_lp

    lp = random_standard_lp(60, 110, seed=4)
    opts = PDHGOptions(max_iters=600, tol=1e-6, check_every=50)
    held = []
    for _ in range(3):
        engine.GRAPHS.update(captures=0, replays=0)
        solve_jit(lp, opts, device=cuda)
        torch.cuda.synchronize()
        assert engine.GRAPHS["captures"] == 1
        held.append(torch.cuda.memory_allocated())
    assert held[1] == held[0] and held[2] == held[0]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ell", "coo"])
def test_captured_sparse_batch_loop_equals_eager_on_card(cuda, kind):
    """A batched stepped loop on the ELL (B4) and COO operators, as a CUDA
    graph on a side stream and eagerly: equal iterations per lane, x to
    1e-12 (the COO scatter adds in no fixed order) and equal launches."""
    B, m, n = 3, 40, 70
    K, vecs, state, _, _ = _problem(9, (B,), m, n, torch.float64, cuda)
    K = torch.where(torch.rand(K.shape, device=cuda) < 0.2, K,
                    torch.zeros((), dtype=K.dtype, device=cuda))
    if kind == "ell":
        forms = []
        for M in (K, K.mT):
            W = int((M != 0).sum(-1).max())
            idx = torch.argsort((M == 0).to(torch.int8), dim=-1,
                                stable=True)[..., :W]
            data = torch.gather(M, -1, idx)
            forms += [data.contiguous(),
                      torch.where(data != 0, idx, 0).to(torch.int32)
                      .contiguous()]
        op = engine.sparse_ell_operator(*forms)
    else:
        op = engine.sparse_operator(K.to_sparse())
    out = {}
    for graph in (True, False):
        kernels.reset_launch_counts()
        res = engine.drain(engine.pdhg_loop(
            op, engine.make_updates("cuda"), *vecs.values(), state.x,
            state.y, 0.3, 0.3, max_iters=2000, tol=1e-6, gamma=0.0,
            check_every=40, restart_beta=0.5, graph=graph))
        out[graph] = (res, kernels.launch_counts())
    (xa, _, ia, _, wa), ca = out[True]
    (xb, _, ib, _, wb), cb = out[False]
    assert wa == wb and torch.equal(ia, ib) and ca == cb
    assert float((xa - xb).abs().max()) <= 1e-12
    if kind == "ell":
        assert torch.equal(xa, xb)
