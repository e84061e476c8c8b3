"""Distributed in-memory PDHG over ``torch.distributed`` process groups;
the port of ``repro.distributed.pdhg_dist``.

The rank grid is the crossbar grid: each rank owns a static tile of the
Ruiz-scaled constraint matrix K.  Per iteration:

  dual step   K @ x_bar : local (m_loc, n_loc) @ (n_loc,) then an
              all-reduce over the COLUMN group ("model")  -- "sum the
              currents"
  primal step K^T @ y   : local transpose product then an all-reduce
              over the ROW group ("pod", "data")

Vectors are the only thing that ever moves (two all-reduces an
iteration, ``engine.sharded_operator``); K is placed once at setup.
Each check adds the merit's two all-reduces (one stacked vector of sums
per axis, ``_dist_kkt_max``) for the current iterate and two for the
average; ``step_rule="adaptive"`` adds the scalar all-reduces of its
hooks.  Every rank runs this module's functions on the same arguments
(SPMD), and the loop's one host read a window comes from all-reduced
values only, so every rank leaves the loop in the same window.

The iteration itself is ``core.engine``'s stepped loop with the port's
update kernels (the schedule once a window, B1's and B2's step forms a
step); the windows run eagerly, since a collective is not captured.

Exposes:
  * ``make_dist_step``  -- a k-iteration step on this rank's blocks;
  * ``solve_dist``      -- pad, shard, engine loop with KKT checks and
                           restarts, gather, unscale;
  * ``solve_dist_auto`` -- ``solve_dist`` over the cluster mesh
                           (``runtime.cluster``), or over the local
                           mesh in one process.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import engine
from ..core import pdhg as pdhg_mod
from ..core.engine import all_reduce
from ..core.pdhg import PDHGOptions, PDHGResult
from ..core.residuals import kkt_residuals
from ..interop import Draws
from ..lp.problem import StandardLP
from .sharding import (
    axis_size,
    col_axes,
    gather_blocks,
    local_block,
    pad_to_multiple,
    row_axes,
)


def _l2sq(v):
    return torch.sum(v * v)


def _dist_kkt_max(x, x_prev, y, c, b, Kx, KTy, lb, ub, row_group,
                  col_group):
    """The max KKT residual from this rank's blocks and two all-reduces.

    x-like blocks are split over the column group, y-like over the row
    group.  Each axis's local sums are stacked into one vector and
    all-reduced once; each entry is reduced on its own, so the values
    are those of one all-reduce a sum, and every rank computes the same
    merit from them (the loop's exit decision)."""
    reduced = c - KTy
    has_lb = torch.isfinite(lb)
    has_ub = torch.isfinite(ub)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    lam_lo = torch.where(has_lb, torch.clamp(reduced, min=0.0), zero)
    lam_hi = torch.where(has_ub, torch.clamp(-reduced, min=0.0), zero)
    lam = lam_lo - lam_hi
    cols = all_reduce(torch.stack([
        _l2sq(c), _l2sq(reduced - lam),
        _l2sq(torch.clamp(x_prev - x, min=0.0)), _l2sq(x),
        torch.dot(c, x),
        torch.dot(torch.where(has_lb, lb, zero), lam_lo)
        - torch.dot(torch.where(has_ub, ub, zero), lam_hi)]), col_group)
    rows = all_reduce(torch.stack([_l2sq(b), _l2sq(Kx - b), torch.dot(b, y)]),
                      row_group)
    nrm_b = torch.sqrt(rows[0])
    nrm_c = torch.sqrt(cols[0])
    r_pri = torch.sqrt(rows[1]) / (1.0 + nrm_b)
    r_dual = torch.sqrt(cols[1]) / (1.0 + nrm_c)
    r_iter = torch.sqrt(cols[2]) / (1.0 + torch.sqrt(cols[3]))
    pobj = cols[4]
    dobj = rows[2] + cols[5]
    r_gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj)
                                      + torch.abs(dobj))
    return torch.maximum(torch.maximum(r_pri, r_dual),
                         torch.maximum(r_iter, r_gap))


@dataclasses.dataclass
class DistProblem:
    """This rank's blocks of the padded problem (the 'encoded' state):
    ``K`` its (m_pad / R, n_pad / C) tile, ``b``/``Sigma`` its blocks
    over the row axes, ``c``/``lb``/``ub``/``T`` over the column axes."""

    K: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    T: torch.Tensor
    Sigma: torch.Tensor
    m: int               # original dims
    n: int
    mesh: object
    m_pad: int = 0       # padded dims
    n_pad: int = 0


def shard_problem(scaled, T, Sigma, mesh, tile_dtype=None) -> DistProblem:
    """Pad to mesh multiples and keep this rank's blocks (the
    encode-once step).

    Padding semantics: extra primal coordinates are pinned (lb = ub = 0,
    T = 1) and extra rows have b = 0, Sigma = 1 and zero K rows, so
    padding never changes the optimum.  ``tile_dtype`` narrows the
    K tile (bf16 "conductances"); vectors keep the solve's type."""
    Rax, Cax = row_axes(mesh), col_axes(mesh)
    R, C = axis_size(mesh, Rax), axis_size(mesh, Cax)
    m, n = scaled.K.shape
    Kp = pad_to_multiple(pad_to_multiple(scaled.K, R, 0), C, 1)
    K_loc = local_block(Kp, mesh, (Rax, Cax)).contiguous()
    if tile_dtype is not None:
        K_loc = K_loc.to(tile_dtype)

    def rows(v, value=0.0):
        return local_block(pad_to_multiple(v, R, 0, value), mesh, (Rax,))

    def cols(v, value=0.0):
        return local_block(pad_to_multiple(v, C, 0, value), mesh, (Cax,))

    return DistProblem(
        K=K_loc, b=rows(scaled.b), c=cols(scaled.c), lb=cols(scaled.lb),
        ub=cols(scaled.ub),            # ub padded with 0: pinned vars
        T=cols(T, 1.0), Sigma=rows(Sigma, 1.0), m=m, n=n, mesh=mesh,
        m_pad=Kp.shape[0], n_pad=Kp.shape[1])


def _groups(mesh):
    return mesh.group(row_axes(mesh)), mesh.group(col_axes(mesh))


def make_dist_step(mesh, n_inner: int = 1, gamma: float = 0.0):
    """A k-iteration distributed PDHG step (the dry-run/roofline unit).

    Returns ``step(K, b, c, lb, ub, T, Sigma, x, x_bar, y, tau, sigma)
    -> (x, x_bar, y, tau, sigma)`` on this rank's blocks (those of a
    ``DistProblem``), running ``n_inner`` engine iterations
    (``engine.pdhg_step`` with the update kernels: their plain versions
    on CPU tensors) over the sharded operator.  State is the engine's
    carried form: ``x_bar`` is the next iteration's extrapolated point
    and ``tau``/``sigma`` already include its theta factor."""
    row_group, col_group = _groups(mesh)

    def step(K, b, c, lb, ub, T, Sigma, x, x_bar, y, tau, sigma):
        op = engine.sharded_operator(K, row_group, col_group)
        state = engine.PDHGState(x=x, x_prev=x, x_bar=x_bar, y=y,
                                 tau=tau, sigma=sigma)
        for _ in range(n_inner):
            state = engine.pdhg_step(op, engine.CUDA_UPDATES, b, c, lb, ub,
                                     T, Sigma, gamma, state)
        return state.x, state.x_bar, state.y, state.tau, state.sigma

    return step


def _start(prob: DistProblem, opts: PDHGOptions, draws: Optional[Draws]):
    """This rank's blocks of the start iterate.  Every rank draws the
    FULL vectors (x0 of n_pad, then y0 of m_pad) from a generator seeded
    ``opts.seed + 1`` on its device, as ``solve_jit`` draws, or takes
    the injected ``draws`` (zero-padded to the padded dims), and keeps
    its blocks: every mesh starts from the same point, and a 1x1 mesh
    from ``solve_jit``'s."""
    mesh, dt, dev = prob.mesh, prob.b.dtype, prob.b.device
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(opts.seed + 1)
        x0 = torch.randn(prob.n_pad, generator=gen, dtype=dt, device=dev)
        y0 = torch.randn(prob.m_pad, generator=gen, dtype=dt, device=dev)
    else:
        def full(a, size):
            v = torch.zeros(size, dtype=dt, device=dev)
            a = torch.as_tensor(np.array(a), dtype=dt, device=dev)
            v[:a.shape[0]] = a
            return v

        x0, y0 = full(draws.x0, prob.n_pad), full(draws.y0, prob.m_pad)
    x0 = torch.clamp(local_block(x0, mesh, (col_axes(mesh),)),
                     prob.lb, prob.ub)
    return x0, local_block(y0, mesh, (row_axes(mesh),))


def solve_dist(
    lp: StandardLP,
    mesh,
    opts: PDHGOptions = PDHGOptions(),
    tile_dtype=None,
    *,
    draws: Optional[Draws] = None,
) -> PDHGResult:
    """The full distributed solve on this rank: prep, norm, shard, the
    engine loop on the sharded operator, gather, unscale.  Every rank of
    ``mesh`` calls it with the same arguments and returns the whole
    result.

    Each rank prepares the whole problem on its device and estimates
    the norm as ``solve_jit`` does (its rank-0 value, all-reduced by a
    max, is every rank's); ``tile_dtype`` widens it by the reference's
    Lemma-2 margin for tile rounding.  ``draws`` injects x0, y0 (full
    vectors) and the norm estimate's start, as in ``solve_jit``."""
    dev = mesh.device
    scaled, T, Sigma = pdhg_mod.prepare(lp, opts, dev)
    v0 = None if draws is None or draws.v0 is None else torch.as_tensor(
        np.array(draws.v0), dtype=scaled.K.dtype, device=dev)
    if opts.norm_override is not None:
        rho = torch.tensor(float(opts.norm_override), dtype=scaled.K.dtype,
                           device=dev)
    else:
        from ..core.lanczos import NORM_BACKENDS

        if opts.norm_backend not in NORM_BACKENDS:
            raise ValueError(f"unknown norm_backend {opts.norm_backend!r}; "
                             f"expected one of {NORM_BACKENDS}")
        rho = pdhg_mod._norm_estimate(scaled.K, T, Sigma, opts, v0)
        if tile_dtype is not None:
            rho = rho / (1.0 - 0.05)   # Lemma-2 margin for tile rounding
    everyone = mesh.group(mesh.axis_names)
    rho = all_reduce(rho.reshape(1).clone(), everyone, op="max")[0]
    prob = shard_problem(scaled, T, Sigma, mesh, tile_dtype=tile_dtype)
    Rax, Cax = row_axes(mesh), col_axes(mesh)
    row_group, col_group = _groups(mesh)
    x0, y0 = _start(prob, opts, draws)
    op = engine.sharded_operator(prob.K, row_group, col_group)
    b, c, lb, ub = prob.b, prob.c, prob.lb, prob.ub

    def residual_fn(x, x_prev, y, Kx, KTy):
        return _dist_kkt_max(x, x_prev, y, c, b, Kx, KTy, lb, ub,
                             row_group, col_group)

    # the adaptive rebalance reduces x-like vectors over the column
    # group and y-like over the rows, as the merit's norms do; padded
    # coordinates are pinned (dx = dy = 0), so they never bias it
    def xsum_fn(v):
        return all_reduce(torch.sum(v, dim=-1), col_group)

    def ysum_fn(v):
        return all_reduce(torch.sum(v, dim=-1), row_group)

    # as engine.solve_core: a zero operator's rho would make tau0 = inf
    rho_c = torch.clamp(rho, min=1e-12)
    x, y, its, merit, _ = engine.drain(engine.pdhg_loop(
        op, engine.make_updates(opts.kernel), b, c, lb, ub, prob.T,
        prob.Sigma, x0, y0, opts.eta / (opts.omega * rho_c),
        opts.eta * opts.omega / rho_c,
        max_iters=opts.max_iters, tol=opts.tol, gamma=opts.gamma,
        check_every=opts.check_every, restart_beta=opts.restart_beta,
        restart=opts.restart, step_rule=opts.step_rule, eta=opts.eta,
        xsum_fn=xsum_fn, ysum_fn=ysum_fn, residual_fn=residual_fn))
    x = gather_blocks(x, mesh, Cax)[: prob.n]
    y = gather_blocks(y, mesh, Rax)[: prob.m]
    x_orig = scaled.unscale_x(x).cpu().numpy()
    y_orig = scaled.unscale_y(y).cpu().numpy()
    # post-hoc noiseless KKT residuals of the UNSCALED solution, one per
    # component, as every other path reports them; the in-loop merit
    # drives the status and ``result.merit``
    K = np.asarray(lp.K_dense)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    res = kkt_residuals(t(x_orig), t(x_orig), t(y_orig), t(lp.c), t(lp.b),
                        t(K @ x_orig), t(K.T @ y_orig), lb=t(lp.lb),
                        ub=t(lp.ub))
    it = int(its)
    lanczos_mvms = 0 if opts.norm_override is not None else opts.lanczos_iters
    merit_f = float(merit)
    if not np.isfinite(merit_f):
        status = "diverged"          # NaN exits the loop; report it truly
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


def solve_dist_auto(
    lp: StandardLP,
    opts: PDHGOptions = PDHGOptions(),
    cluster: str = "auto",
    tile_dtype=None,
    *,
    device=None,
    draws: Optional[Draws] = None,
) -> PDHGResult:
    """``solve_dist`` over the process-spanning mesh.

    Brings the cluster up through ``runtime.cluster.init_cluster``
    (env-driven, idempotent, single-process fallback) and solves over
    ``make_cluster_mesh()`` -- in a multi-process deployment the pod
    axis is one process per pod and every all-reduce crosses processes;
    in one process this is the local mesh (one rank), so every entry
    point keeps working unchanged."""
    from ..runtime import cluster as cluster_mod
    from ..runtime.mesh import make_cluster_mesh, make_local_mesh

    info = cluster_mod.init_cluster(cluster)
    mesh = (make_cluster_mesh(device=device) if info.is_multiprocess
            else make_local_mesh(device=device))
    return solve_dist(lp, mesh, opts, tile_dtype=tile_dtype, draws=draws)
