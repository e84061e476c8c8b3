"""Enhanced PDHG for LPs (paper Algorithm 4): the port of
``repro.core.pdhg``, in PyTorch.

Iteration (sign convention of eq. 7):

    theta_k = 1 / sqrt(1 + 2*gamma*tau)        # deterministic adaptation
    tau    <- theta_k * tau;   sigma <- sigma / theta_k    # tau*sigma const
    x_bar  = x_k + theta_k (x_k - x_{k-1})     # momentum extrapolation
    y_{k+1} = y_k + sigma * Sigma ⊙ (b - K x_bar)          # 1 MVM
    x_{k+1} = proj_[lb,ub]( x_k - tau * T ⊙ (c - K^T y_{k+1}) )  # 1 MVM

Two drivers, both on ``cuda`` unless ``device`` says otherwise (they
raise when no card is visible and none was named):

  * ``solve``      — the host loop (Algorithm 4) over an ``Accel``
                     backend: every MVM is one read of the encoded M
                     (the crossbar simulation with its energy ledger),
                     with restarts, the adaptive rule, history and the
                     divergence/Farkas exit.
  * ``solve_jit``  — keeps the reference's name: the device-resident
                     dense solve (Ruiz + Pock–Chambolle + Lanczos + the
                     engine's loop), although PyTorch runs it eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import spans
from .._device import resolve_device
from ..interop import Draws, lp_tensors, place_draws
from . import engine
from . import precondition as precond_mod
from .infeasibility import check_farkas
from .lanczos import (
    NORM_BACKENDS,
    lanczos_svd,
    lanczos_svd_jit,
    power_iteration_mv,
)
from .noise import NOISELESS, NoiseModel
from .residuals import KKTResiduals, kkt_residuals
from .symblock import build_sym_block, encode_exact, encode_noisy, scaled_accel


@dataclasses.dataclass
class PDHGOptions:
    """The reference's options, field for field.  ``kernel`` names the
    port's update backends (``"torch"`` | ``"cuda"``, the counterparts
    of ``"jnp"`` | ``"pallas"``) and defaults to the CUDA kernels;
    ``dtype`` is a torch dtype (a numpy float dtype is accepted)."""

    max_iters: int = 20000
    tol: float = 1e-6
    eta: float = 0.95              # safety margin (paper: eta ~ 0.95)
    omega: float = 1.0             # primal weight (tau = eta/(omega L), sigma = eta omega/L)
    gamma: float = 0.0             # Nesterov acceleration parameter (>=0)
    ruiz_iters: int = 10
    use_diag_precond: bool = True
    lanczos_iters: int = 64
    lanczos_tol: float = 1e-8
    check_every: int = 64
    restart: bool = True
    restart_beta: float = 0.5      # restart when merit(avg) < beta * merit at last restart
    infeasibility_detection: bool = True
    seed: int = 0
    dtype: object = torch.float64
    track_history: bool = False
    norm_override: Optional[float] = None  # skip Lanczos (reuse across runs)
    kernel: str = "cuda"           # update backend: "torch" | "cuda"
    sparse_kernel: str = "ell"     # sparse operator backend (batch slice)
    megakernel: bool = False       # fuse each check_every window into ONE
    #                                kernel launch (noiseless paths only;
    #                                a card's noiseless dense window is
    #                                fused without it where engine.
    #                                transpose_form_window picks it)
    step_rule: str = "fixed"       # "fixed" | "adaptive" | "strongly_convex"
    norm_backend: str = "lanczos"  # "lanczos" (Algorithm 3) | "power"
    refine_rounds: int = 0         # digital refinement rounds (crossbar slice)
    refine_tol: float = 0.0


@dataclasses.dataclass
class PDHGResult:
    status: str                 # "optimal" | "iteration_limit" |
    #                             "diverged" | "primal_infeasible"
    x: np.ndarray               # solution in ORIGINAL (unscaled) coordinates
    y: np.ndarray
    obj: float
    iterations: int
    residuals: KKTResiduals
    sigma_max: float            # operator-norm estimate used
    lanczos_iters: int
    mvm_calls: int              # total device MVMs issued (energy ledger)
    history: Optional[list] = None
    restarts: int = 0
    certificate: Optional[object] = None
    merit: Optional[float] = None  # in-loop merit at exit


# PDHGOptions fields that stay out of the ``opts_static`` tuple, as in
# the reference.
DYNAMIC_FIELDS = (
    "ruiz_iters", "use_diag_precond", "lanczos_iters", "lanczos_tol",
    "infeasibility_detection", "seed", "dtype", "track_history",
    "norm_override", "norm_backend",
)

_NUMPY_DTYPES = {np.dtype(np.float64): torch.float64,
                 np.dtype(np.float32): torch.float32}


def torch_dtype(dtype) -> torch.dtype:
    """``PDHGOptions.dtype`` as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NUMPY_DTYPES[np.dtype(dtype)]


def opts_static(opts: PDHGOptions, sigma_read: float = 0.0) -> tuple:
    """The option tuple ``engine.solve_core`` consumes, validated with
    the reference's ``ValueError``s (positional: keep in sync with the
    head of ``solve_core``)."""
    if opts.kernel not in engine.KERNELS:
        raise ValueError(f"unknown update kernel {opts.kernel!r}; "
                         f"expected one of {engine.KERNELS}")
    if opts.sparse_kernel not in engine.SPARSE_KERNELS:
        raise ValueError(f"unknown sparse kernel {opts.sparse_kernel!r}; "
                         f"expected one of {engine.SPARSE_KERNELS}")
    if opts.megakernel and float(sigma_read) > 0.0:
        raise ValueError("megakernel mode is noiseless-only: per-MVM "
                         "read-noise keys cannot be split inside a fused "
                         "launch (sigma_read must be 0)")
    if opts.step_rule not in engine.STEP_RULES:
        raise ValueError(f"unknown step_rule {opts.step_rule!r}; expected "
                         f"one of {engine.STEP_RULES}")
    if opts.step_rule == "strongly_convex" and not opts.gamma > 0.0:
        raise ValueError("step_rule='strongly_convex' is the accelerated "
                         "theta_k schedule and requires gamma > 0")
    if opts.step_rule != "strongly_convex" and opts.gamma != 0.0:
        raise ValueError(f"gamma > 0 drives the strongly-convex schedule; "
                         f"set step_rule='strongly_convex' explicitly "
                         f"(got gamma={opts.gamma} with "
                         f"step_rule={opts.step_rule!r})")
    if opts.refine_rounds < 0:
        raise ValueError(f"refine_rounds must be >= 0 "
                         f"(got {opts.refine_rounds})")
    return (opts.max_iters, opts.tol, opts.eta, opts.omega, opts.gamma,
            opts.check_every, opts.restart_beta, float(sigma_read),
            opts.kernel, bool(opts.restart), opts.sparse_kernel,
            bool(opts.megakernel), opts.step_rule,
            int(opts.refine_rounds), float(opts.refine_tol))


def prepare(lp, opts: PDHGOptions, device=None):
    """Step 0 of Algorithm 4 on ``device``: Ruiz scaling and the
    Pock–Chambolle diagonals.  Returns ``(scaled, T, Sigma)``."""
    dev = resolve_device(device)
    dt = torch_dtype(opts.dtype)
    with spans.span("solve.prepare"):
        t = lp_tensors(lp, dev, dt)
        scaled = precond_mod.apply_ruiz(t.K, t.b, t.c, t.lb, t.ub,
                                        iters=opts.ruiz_iters)
        del t
        if opts.use_diag_precond:
            T, Sigma = precond_mod.diagonal_precondition(scaled.K)
        else:
            m, n = scaled.K.shape
            T = torch.ones(n, dtype=dt, device=dev)
            Sigma = torch.ones(m, dtype=dt, device=dev)
    return scaled, T, Sigma


def solve(
    lp,
    opts: PDHGOptions = PDHGOptions(),
    accel_factory: Optional[Callable] = None,
    noise: NoiseModel = NOISELESS,
    on_iteration: Optional[Callable] = None,
    *,
    device=None,
    draws: Optional[Draws] = None,
) -> PDHGResult:
    """Algorithm 4 host driver over an arbitrary accelerator backend.

    ``accel_factory(K_scaled) -> Accel`` (default: the exact dense
    backend, or ``noise`` on top of it, drawn from a generator seeded
    with ``opts.seed``; a crossbar backend brings its own physics).
    ``draws`` injects x0, y0 and the Lanczos start vector; by default
    they come from generators seeded with ``opts.seed`` (Lanczos, drawn
    on the CPU) and ``opts.seed + 1`` (x0, y0).  The loop reads the
    merit on the host once per check (and the averaged iterate's merit
    when restarts are on); ``mvm_calls`` is ``accel.stats``'s count.
    """
    dev = resolve_device(device)
    opts_static(opts)    # shared option validation (step_rule/kernel/...)
    scaled, T, Sigma = prepare(lp, opts, dev)
    m, n = scaled.K.shape
    dt = scaled.K.dtype

    if accel_factory is None:
        if noise.kind == "none":
            accel = encode_exact(scaled.K)
        else:
            accel = encode_noisy(
                scaled.K, noise.apply,
                generator=torch.Generator(device=dev).manual_seed(opts.seed))
    else:
        accel = accel_factory(scaled.K)
    x, y, v0 = place_draws(draws, scaled.lb, scaled.ub)

    # ---- Step 1: operator-norm estimation on the PRECONDITIONED
    # operator, by Lanczos on the similarity wrap diag(Sigma^1/2, T^1/2)
    # M diag(Sigma^1/2, T^1/2) (host-side scaling, no device rewrite):
    # rho = ||Sigma^1/2 K T^1/2||_2, and the diagonal steps (tau T,
    # sigma Sigma) converge for tau*sigma*rho^2 < 1 (Lemma 2).
    if opts.norm_override is not None:
        rho = float(opts.norm_override)
        lanczos_iters = 0
    else:
        wrapped = scaled_accel(accel, torch.sqrt(Sigma), torch.sqrt(T))
        lres = lanczos_svd(wrapped, k_max=opts.lanczos_iters,
                           tol=opts.lanczos_tol, v0=v0, reorthogonalize=True,
                           seed=opts.seed, dtype=dt, device=dev)
        rho = lres.sigma_max
        lanczos_iters = lres.iterations

    tau = opts.eta / (opts.omega * rho)
    sigma = opts.eta * opts.omega / rho
    adaptive = opts.step_rule == "adaptive"
    adapt_prev = None               # previous boundary (x, y, Kx, KTy)
    yes = torch.ones((), dtype=torch.bool, device=dev)
    if adaptive:
        # data-driven primal-weight init + trust region (engine math)
        tau, sigma = engine.adaptive_omega_init(
            torch.as_tensor(tau, dtype=dt, device=dev),
            torch.as_tensor(sigma, dtype=dt, device=dev),
            scaled.b, scaled.c, T, Sigma)
        w0 = torch.sqrt(sigma / tau)
        w_lo = w0 / engine.ADAPT_OMEGA_CLIP
        w_hi = w0 * engine.ADAPT_OMEGA_CLIP

    # ---- Step 2: initialization (paper: projected Gaussian start).
    if x is None:
        x, y = engine.draw_init(
            torch.Generator(device=dev).manual_seed(opts.seed + 1), m, n,
            scaled.lb, scaled.ub, dt)
    # running ergodic sums for restarts / averaged iterate
    x_sum = torch.zeros_like(x)
    y_sum = torch.zeros_like(y)
    avg_len = 0
    merit_at_restart = np.inf
    n_restarts = 0

    history = [] if opts.track_history else None
    status = "iteration_limit"
    res = None
    it = 0

    # the per-iteration math is the engine's; this driver owns only the
    # host-level control flow (history, callbacks, the exits)
    op = engine.accel_operator(accel)
    upd = engine.make_updates(opts.kernel)
    state = engine.init_state(x, y, tau, sigma, opts.gamma)
    adapt_anchor = (state.x, state.y)   # restart anchor for omega updates
    del x, y, tau, sigma

    def residuals(x, x_prev, y, Kx, KTy):
        return kkt_residuals(x, x_prev, y, scaled.c, scaled.b, Kx, KTy,
                             lb=scaled.lb, ub=scaled.ub)

    for it in range(opts.max_iters):
        state = engine.pdhg_step(op, upd, scaled.b, scaled.c, scaled.lb,
                                 scaled.ub, T, Sigma, opts.gamma, state)
        x_sum = x_sum + state.x
        y_sum = y_sum + state.y
        avg_len += 1

        if (it + 1) % opts.check_every == 0 or it == opts.max_iters - 1:
            Kx = op.fwd(state.x)
            KTy_c = op.adj(state.y)
            res = residuals(state.x, state.x_prev, state.y, Kx, KTy_c)
            merit = float(res.max)
            if history is not None:
                history.append(
                    {"iter": it + 1, "merit": merit, **res.as_dict(),
                     "obj": float(torch.dot(scaled.c, state.x))})
            if on_iteration is not None:
                on_iteration(it + 1, merit, accel)
            if not np.isfinite(merit):
                # NaN/inf merit: the iterate blew up (NaN fails every
                # comparison below)
                status = "diverged"
                break
            if merit <= opts.tol:
                status = "optimal"
                break
            if opts.infeasibility_detection and merit > 1e8:
                status = "diverged"
                break
            Kx_b, KTy_b = Kx, KTy_c   # images of the iterate carried on
            if opts.restart and avg_len > 0:
                x_avg = x_sum / avg_len
                y_avg = y_sum / avg_len
                Kxa = op.fwd(x_avg)
                KTya = op.adj(y_avg)
                merit_avg = float(residuals(x_avg, x_avg, y_avg, Kxa,
                                            KTya).max)
                if merit_avg < opts.restart_beta * merit_at_restart:
                    # restart from the (better) averaged iterate
                    if merit_avg < merit:
                        state = engine.restart_state(state, x_avg, y_avg)
                        Kx_b, KTy_b = Kxa, KTya
                    merit_at_restart = min(merit_avg, merit)
                    x_sum = torch.zeros_like(state.x)
                    y_sum = torch.zeros_like(state.y)
                    avg_len = 0
                    n_restarts += 1
                    if adaptive:
                        # primal-weight rebalance rides restart events
                        rx, ry = adapt_anchor
                        tau_n, sigma_n = engine.adaptive_omega_update(
                            state.tau, state.sigma, state.x - rx,
                            state.y - ry, T, Sigma, w_lo, w_hi, yes)
                        state = state._replace(tau=tau_n, sigma=sigma_n)
                        adapt_anchor = (state.x, state.y)
            if adaptive:
                # boundary-only down-only scale safeguard; K(dx)/K^T(dy)
                # come from the check MVMs by linearity
                if adapt_prev is not None:
                    px, py, pKx, pKTy = adapt_prev
                    tau_n, sigma_n = engine.adaptive_shrink(
                        state.tau, state.sigma, opts.eta,
                        state.x - px, state.y - py,
                        Kx_b - pKx, KTy_b - pKTy, T, Sigma, yes)
                    state = state._replace(tau=tau_n, sigma=sigma_n)
                adapt_prev = (state.x, state.y, Kx_b, KTy_b)

    x_orig = scaled.unscale_x(state.x).cpu().numpy()
    y_orig = scaled.unscale_y(state.y).cpu().numpy()
    if res is None:
        res = residuals(state.x, state.x, state.y, op.fwd(state.x),
                        op.adj(state.y))
    certificate = None
    if status == "diverged" and opts.infeasibility_detection:
        # PDHG's dual iterate diverges along a Farkas ray on primal-
        # infeasible instances [51]; the diagonal rescaling preserves
        # certificates
        cert = check_farkas(np.asarray(lp.K_dense), np.asarray(lp.b),
                            y_orig, tol=1e-5)
        if cert.kind != "none":
            status = "primal_infeasible"
            certificate = cert
    return PDHGResult(
        status=status,
        x=x_orig,
        y=y_orig,
        obj=float(np.asarray(lp.c) @ x_orig),
        iterations=it + 1,
        residuals=res,
        sigma_max=rho,
        lanczos_iters=lanczos_iters,
        mvm_calls=accel.stats["mvm_calls"],
        history=history,
        restarts=n_restarts,
        certificate=certificate,
        merit=float(res.max),
    )


def _norm_estimate(Kf, T, Sigma, opts: PDHGOptions, v0):
    """rho = ||Sigma^1/2 K T^1/2||_2 by Lanczos (or power iteration) on
    the symmetric block M, which exists only inside this call (the span
    ``solve.norm``)."""
    with spans.span("solve.norm"):
        Keff = torch.sqrt(Sigma)[:, None] * Kf * torch.sqrt(T)[None, :]
        M = build_sym_block(Keff)
        del Keff
        if opts.norm_backend == "power":
            return power_iteration_mv(lambda v: torch.mv(M, v), M.shape[0],
                                      M.dtype, iters=opts.lanczos_iters,
                                      v0=v0, device=M.device)
        return lanczos_svd_jit(M, k_max=opts.lanczos_iters, v0=v0)


def solve_jit(
    lp,
    opts: PDHGOptions = PDHGOptions(),
    K_fwd=None,
    K_adj=None,
    sigma_read: float = 0.0,
    transfer_sanitize: bool = False,
    *,
    device=None,
    draws: Optional[Draws] = None,
) -> PDHGResult:
    """Dense-K solve: Ruiz + PC precond + Lanczos + the engine's loop.

    ``K_fwd``/``K_adj`` override the operator actually executed (already
    in the Ruiz-scaled frame); preconditioning and residuals still come
    from the nominal K.  ``sigma_read`` adds multiplicative per-MVM read
    noise inside the loop.  ``transfer_sanitize`` runs the loop under
    ``runtime.sanitize.no_implicit_transfers()``, reading the host once a
    window through ``sanitize.host_read``: every input is on the device
    by then, so any other transfer the loop makes raises (the prep and
    the result's extraction stay unguarded).  ``draws`` injects the start
    iterate and the norm estimate's start vector (see ``interop.Draws``);
    by default they are drawn from generators seeded with ``opts.seed +
    1`` and 0.

    The call is the span ``solve`` (m, n, dtype), over ``solve.prepare``,
    ``solve.norm``, the loop's spans and ``solve.result``.
    """
    dev = resolve_device(device)
    if opts.norm_backend not in NORM_BACKENDS:
        raise ValueError(f"unknown norm_backend {opts.norm_backend!r}; "
                         f"expected one of {NORM_BACKENDS}")
    static = opts_static(opts, sigma_read)
    m, n = lp.K.shape
    with spans.span("solve", m=int(m), n=int(n),
                    dtype=str(torch_dtype(opts.dtype)).split(".")[-1]):
        scaled, T, Sigma = prepare(lp, opts, dev)
        dt = scaled.K.dtype

        def on_dev(a):
            if not torch.is_tensor(a):
                # a writable copy (JAX arrays are read-only)
                a = np.array(a)
            return torch.as_tensor(a, dtype=dt, device=dev)

        Kf = scaled.K if K_fwd is None else on_dev(K_fwd).contiguous()
        Ka = None if K_adj is None else on_dev(K_adj).contiguous()
        x0, y0, v0 = place_draws(draws, scaled.lb, scaled.ub)
        if opts.norm_override is not None:
            rho = torch.tensor(float(opts.norm_override), dtype=dt,
                               device=dev)
        else:
            rho = engine.lemma2_margin(
                _norm_estimate(Kf, T, Sigma, opts, v0), sigma_read)
        generator = torch.Generator(device=dev).manual_seed(opts.seed + 1)

        def loop(read):
            return engine.drain(engine.solve_core(
                Kf, Ka, scaled.b, scaled.c, scaled.lb, scaled.ub, T, Sigma,
                rho, generator, static, x0=x0, y0=y0, read=read))

        if transfer_sanitize:
            from ..runtime import sanitize   # runtime imports this module

            with sanitize.no_implicit_transfers():
                x, y, _, merit, windows = loop(sanitize.host_read)
        else:
            x, y, _, merit, windows = loop(bool)
        with spans.span("solve.result"):
            # one instance is active in every window it runs
            it = windows * opts.check_every
            x_orig = scaled.unscale_x(x).cpu().numpy()
            y_orig = scaled.unscale_y(y).cpu().numpy()
            res = kkt_residuals(
                x, x, y, scaled.c, scaled.b, torch.mv(scaled.K, x),
                torch.mv(scaled.K.T, y), lb=scaled.lb, ub=scaled.ub)
            lanczos_mvms = (0 if opts.norm_override is not None
                            else opts.lanczos_iters)
            merit_f = float(merit)
            # a non-finite merit exits the loop (NaN > tol is false): report
            # it as divergence, not as a clean iteration limit
            if not np.isfinite(merit_f):
                status = "diverged"
            elif merit_f <= opts.tol:
                status = "optimal"
            else:
                status = "iteration_limit"
            return PDHGResult(
                status=status,
                x=x_orig, y=y_orig, obj=float(np.asarray(lp.c) @ x_orig),
                iterations=it, residuals=res, sigma_max=float(rho),
                lanczos_iters=lanczos_mvms,
                mvm_calls=engine.mvm_accounting(it, opts.check_every,
                                                lanczos_mvms,
                                                restart=opts.restart),
                merit=merit_f,
            )
