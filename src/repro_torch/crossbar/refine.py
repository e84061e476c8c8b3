"""Mixed-precision iterative refinement for the crossbar PDHG solve; the
port of ``repro.crossbar.refine``.

After Le Gallo et al., "Mixed-Precision In-Memory Computing"
(arXiv 1701.04279): the analog crossbar solves fast but only down to its
read-noise floor; a digital outer loop recovers full-precision answers
by repeatedly solving the RESIDUAL-CORRECTION problem on the *same
programmed conductances*.  Substituting x = x_bar + dx, y = y_bar + dy
into the LP saddle gives the same operator K with shifted b/c and a
shifted box, so nothing is ever reprogrammed.  Each round:

  1. DIGITAL: exact residuals r_b = b - Kx, r_c = c - K'y against the
     full-precision operator (counted by ``engine.refine_digital_mvms``,
     never charged to the crossbar read ledger);
  2. scale the correction problem to unit size (s = max residual), so
     the relative read noise's absolute floor shrinks with the residual;
  3. ANALOG: solve the correction LP through ``engine.solve_core`` on
     the programmed operator from dx = dy = 0; every inner MVM is an
     analog read, charged like any other solve;
  4. DIGITAL: adopt the candidate only if it improves the exact KKT
     merit and the merit is still above ``refine_tol`` — a
     ``torch.where`` on the card, so the shell reads nothing on the
     host between rounds.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from ..core import engine
from ..core import pdhg as pdhg_mod
from ..core.residuals import kkt_residuals
from ..interop import Draws, place_draws
from .device import EPIRAM, DeviceModel
from .energy import Ledger

#: guard for an exactly-zero residual (already converged): the
#: correction problem degenerates and the scale must not divide by zero
_TINY = 1e-300


def digital_merit(x, y, b, c, lb, ub, Kx, KTy):
    """Exact KKT merit from full-precision operator images."""
    return kkt_residuals(x, x, y, c, b, Kx, KTy, lb=lb, ub=ub).max


def refined_core(K_dig_fwd, K_dig_adj, K_fwd, K_adj, b, c, lb, ub, T,
                 Sigma, rho, generator, static, *,
                 operator: Optional[engine.Operator] = None, x0=None,
                 y0=None):
    """Digital-outer / analog-inner refinement shell.

    ``K_dig_fwd``/``K_dig_adj`` are the EXACT scaled operator blocks,
    used only for the digital residual/merit MVMs; ``K_fwd``/``K_adj``
    (or ``operator``) is the programmed analog operator every inner
    solve runs on, identical in every round.  ``static`` is the
    ``pdhg.opts_static`` tuple: entries 13 (``refine_rounds``) and 14
    (``refine_tol``) drive the shell, the rest goes to
    ``engine.solve_core``.  ``x0``/``y0`` start the first solve (by
    default drawn from ``generator``, which also drives the read noise).

    Returns ``(x, y, its, merit)`` with ``its`` the per-round iteration
    counts (``refine_rounds + 1`` ints) and ``merit`` the exact digital
    KKT merit after refinement (``refine_rounds == 0``: the first
    solve's in-loop merit)."""
    rounds = int(static[13]) if len(static) > 13 else 0
    refine_tol = float(static[14]) if len(static) > 14 else 0.0

    x, y, it0, merit0 = engine.solve_core(
        K_fwd, K_adj, b, c, lb, ub, T, Sigma, rho, generator, static,
        operator=operator, x0=x0, y0=y0)
    if rounds == 0:
        return x, y, [it0], merit0

    its = [it0]
    Kx = torch.mv(K_dig_fwd, x)
    KTy = torch.mv(K_dig_adj, y)
    merit = digital_merit(x, y, b, c, lb, ub, Kx, KTy)
    tiny = torch.full((), _TINY, dtype=b.dtype, device=b.device)
    for _ in range(rounds):
        rb = b - Kx
        rc = c - KTy
        # unit-scale the correction problem: relative analog noise means
        # the absolute error floor of the inner solve tracks s downward
        s = torch.maximum(torch.maximum(torch.max(torch.abs(rb)),
                                        torch.max(torch.abs(rc))), tiny)
        dx, dy, it_r, _ = engine.solve_core(
            K_fwd, K_adj, rb / s, rc / s, (lb - x) / s, (ub - x) / s,
            T, Sigma, rho, generator, static, operator=operator,
            x0=torch.zeros_like(x), y0=torch.zeros_like(y))
        its.append(it_r)
        x_c = torch.clamp(x + s * dx, lb, ub)
        y_c = y + s * dy
        Kx_c = torch.mv(K_dig_fwd, x_c)
        KTy_c = torch.mv(K_dig_adj, y_c)
        merit_c = digital_merit(x_c, y_c, b, c, lb, ub, Kx_c, KTy_c)
        # safeguarded adoption: keep only an exact improvement, and stop
        # moving once the target tolerance is met
        adopt = (merit_c < merit) & (merit > refine_tol)
        x, y = torch.where(adopt, x_c, x), torch.where(adopt, y_c, y)
        Kx = torch.where(adopt, Kx_c, Kx)
        KTy = torch.where(adopt, KTy_c, KTy)
        merit = torch.where(adopt, merit_c, merit)
    return x, y, its, merit


def solve_crossbar_refined(
    lp,
    opts: pdhg_mod.PDHGOptions,
    device: DeviceModel = EPIRAM,
    seed: Optional[int] = None,
    ledger: Optional[Ledger] = None,
    *,
    torch_device=None,
    program_draw=None,
    draws: Optional[Draws] = None,
):
    """Encode once, then the refined solve with the ledger: the write
    ledger is touched exactly once; refinement rounds add only READ
    windows (plus uncharged digital residual MVMs, ``digital_mvms`` on
    the report).  Arguments as ``solver.solve_crossbar_jit``.  Returns
    a ``CrossbarSolveReport``."""
    from .solver import CrossbarSolveReport, _charge_reads, program_blocks

    dev = resolve_device(torch_device)
    static = pdhg_mod.opts_static(opts, device.sigma_read)
    seed = opts.seed if seed is None else seed
    ledger = ledger if ledger is not None else Ledger()
    scaled, T, Sigma, K_fwd, K_adj, active_cells = program_blocks(
        lp, opts, device, seed, ledger, dev, program_draw)
    dt = scaled.K.dtype
    x0, y0, v0 = place_draws(draws, scaled.lb, scaled.ub)
    if opts.norm_override is not None:
        rho = torch.tensor(float(opts.norm_override), dtype=dt, device=dev)
        lanczos_mvms = 0
    else:
        est = pdhg_mod._norm_estimate(K_fwd, T, Sigma, opts, v0)
        rho = engine.lemma2_margin(est, device.sigma_read)
        lanczos_mvms = opts.lanczos_iters

    generator = torch.Generator(device=dev).manual_seed(opts.seed + 1)
    x, y, its, merit = refined_core(
        scaled.K, scaled.K.T, K_fwd, K_adj, scaled.b, scaled.c, scaled.lb,
        scaled.ub, T, Sigma, rho, generator, static, x0=x0, y0=y0)

    pdhg_mvms = sum(engine.mvm_accounting(i, opts.check_every, 0,
                                          restart=opts.restart)
                    for i in its)
    _charge_reads(ledger, device, lanczos_mvms + pdhg_mvms, active_cells)

    x_orig = scaled.unscale_x(x).cpu().numpy()
    y_orig = scaled.unscale_y(y).cpu().numpy()
    res = kkt_residuals(
        x, x, y, scaled.c, scaled.b, torch.mv(scaled.K, x),
        torch.mv(scaled.K.T, y), lb=scaled.lb, ub=scaled.ub)
    merit_f = float(merit)
    if not np.isfinite(merit_f):
        status = "diverged"
    elif merit_f <= opts.tol:
        status = "optimal"
    else:
        status = "iteration_limit"
    it_total = sum(its)
    result = pdhg_mod.PDHGResult(
        status=status, x=x_orig, y=y_orig,
        obj=float(np.asarray(lp.c) @ x_orig),
        iterations=it_total, residuals=res, sigma_max=float(rho),
        lanczos_iters=lanczos_mvms, mvm_calls=lanczos_mvms + pdhg_mvms,
        merit=merit_f,
    )
    return CrossbarSolveReport(
        result=result, ledger=ledger, device=device,
        lanczos_mvms=lanczos_mvms, pdhg_mvms=pdhg_mvms,
        executed_iterations=it_total,
        digital_mvms=engine.refine_digital_mvms(opts.refine_rounds),
    )
