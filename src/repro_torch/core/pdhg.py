"""Enhanced PDHG for LPs (paper Algorithm 4): the dense ``solve_jit``
path of ``repro.core.pdhg``, in PyTorch.

Iteration (sign convention of eq. 7):

    theta_k = 1 / sqrt(1 + 2*gamma*tau)        # deterministic adaptation
    tau    <- theta_k * tau;   sigma <- sigma / theta_k    # tau*sigma const
    x_bar  = x_k + theta_k (x_k - x_{k-1})     # momentum extrapolation
    y_{k+1} = y_k + sigma * Sigma ⊙ (b - K x_bar)          # 1 MVM
    x_{k+1} = proj_[lb,ub]( x_k - tau * T ⊙ (c - K^T y_{k+1}) )  # 1 MVM

``solve_jit`` keeps the reference's name: it is the device-resident
solve (Ruiz + Pock–Chambolle + Lanczos + the engine's loop), although
PyTorch runs it eagerly.  It runs on ``cuda`` unless ``device`` says
otherwise, and raises when no card is visible and none was named.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..interop import Draws, lp_tensors
from . import engine
from . import precondition as precond_mod
from .lanczos import NORM_BACKENDS, lanczos_svd_jit, power_iteration_mv
from .residuals import KKTResiduals, kkt_residuals
from .symblock import build_sym_block


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
    #                                kernel launch (noiseless paths only)
    step_rule: str = "fixed"       # "fixed" | "adaptive" | "strongly_convex"
    norm_backend: str = "lanczos"  # "lanczos" (Algorithm 3) | "power"
    refine_rounds: int = 0         # digital refinement rounds (crossbar slice)
    refine_tol: float = 0.0


@dataclasses.dataclass
class PDHGResult:
    status: str                 # "optimal" | "iteration_limit" | "diverged"
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


def _norm_estimate(Kf, T, Sigma, opts: PDHGOptions, v0):
    """rho = ||Sigma^1/2 K T^1/2||_2 by Lanczos (or power iteration) on
    the symmetric block M, which exists only inside this call."""
    Keff = torch.sqrt(Sigma)[:, None] * Kf * torch.sqrt(T)[None, :]
    M = build_sym_block(Keff)
    del Keff
    if opts.norm_backend == "power":
        return power_iteration_mv(lambda v: torch.mv(M, v), M.shape[0],
                                  M.dtype, iters=opts.lanczos_iters, v0=v0,
                                  device=M.device)
    return lanczos_svd_jit(M, k_max=opts.lanczos_iters, v0=v0)


def solve_jit(
    lp,
    opts: PDHGOptions = PDHGOptions(),
    K_fwd=None,
    K_adj=None,
    sigma_read: float = 0.0,
    *,
    device=None,
    draws: Optional[Draws] = None,
) -> PDHGResult:
    """Dense-K solve: Ruiz + PC precond + Lanczos + the engine's loop.

    ``K_fwd``/``K_adj`` override the operator actually executed (already
    in the Ruiz-scaled frame); preconditioning and residuals still come
    from the nominal K.  ``sigma_read`` adds multiplicative per-MVM read
    noise inside the loop.  ``draws`` injects the start iterate and the
    norm estimate's start vector (see ``interop.Draws``); by default
    they are drawn from generators seeded with ``opts.seed + 1`` and 0.
    """
    dev = resolve_device(device)
    if opts.norm_backend not in NORM_BACKENDS:
        raise ValueError(f"unknown norm_backend {opts.norm_backend!r}; "
                         f"expected one of {NORM_BACKENDS}")
    static = opts_static(opts, sigma_read)
    scaled, T, Sigma = prepare(lp, opts, dev)
    dt = scaled.K.dtype

    def on_dev(a):
        if not torch.is_tensor(a):
            a = np.array(a)     # a writable copy (JAX arrays are read-only)
        return torch.as_tensor(a, dtype=dt, device=dev)

    Kf = scaled.K if K_fwd is None else on_dev(K_fwd).contiguous()
    Ka = (Kf.T if K_adj is None else on_dev(K_adj)).contiguous()
    if opts.norm_override is not None:
        rho = torch.tensor(float(opts.norm_override), dtype=dt, device=dev)
    else:
        v0 = None if draws is None or draws.v0 is None else on_dev(draws.v0)
        rho = engine.lemma2_margin(
            _norm_estimate(Kf, T, Sigma, opts, v0), sigma_read)
    generator = torch.Generator(device=dev).manual_seed(opts.seed + 1)
    x0 = y0 = None
    if draws is not None:
        x0 = torch.clamp(on_dev(draws.x0), scaled.lb, scaled.ub)
        y0 = on_dev(draws.y0)
    x, y, it, merit = engine.solve_core(
        Kf, Ka, scaled.b, scaled.c, scaled.lb, scaled.ub, T, Sigma, rho,
        generator, static, x0=x0, y0=y0)
    x_orig = scaled.unscale_x(x).cpu().numpy()
    y_orig = scaled.unscale_y(y).cpu().numpy()
    res = kkt_residuals(
        x, x, y, scaled.c, scaled.b, torch.mv(scaled.K, x),
        torch.mv(scaled.K.T, y), lb=scaled.lb, ub=scaled.ub)
    lanczos_mvms = 0 if opts.norm_override is not None else opts.lanczos_iters
    merit_f = float(merit)
    # a non-finite merit exits the loop (NaN > tol is false): report it
    # as divergence, not as a clean iteration limit
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
        mvm_calls=engine.mvm_accounting(it, opts.check_every, lanczos_mvms,
                                        restart=opts.restart),
        merit=merit_f,
    )
