"""A plain restarted PDHG for ``min c@x s.t. K x = b, lb <= x <= ub``
(the paper's Algorithm 4 with the fixed step rule), written from the
algorithm in plain PyTorch ops, for one LP at a time:

* Ruiz equilibration (10 passes of row and column infinity norms) and
  the Pock-Chambolle diagonals T, Sigma (alpha = 1);
* the norm of Sigma^1/2 K T^1/2 by power iteration, widened by 5 % so
  that the step sizes stay inside tau sigma rho^2 < 1;
* the iteration y+ = y + sigma Sigma (b - K x_bar), x+ = proj(x - tau T
  (c - K^T y+)), x_bar = 2 x+ - x, with a residual check every
  ``check_every`` steps on the iterate and on the running average, a
  restart to the average when its merit falls below ``restart_beta``
  times the merit at the last restart, and an exit at ``tol``.

The judge uses its scaling and its residuals (``prepare``,
``residuals``, ``merit``); the CPU tests hold ``solve`` to the
generators' known optima.  It runs in any float dtype on any device.
Nothing here is timed.
"""
from __future__ import annotations

import dataclasses
import math
import numpy as np
import torch

class DenseOp:
    """A dense operator."""

    def __init__(self, K: torch.Tensor):
        self.K = K
        self.KT = K.T
        self.shape = tuple(K.shape)

    def mv(self, v):
        return torch.mv(self.K, v)

    def rmv(self, w):
        return torch.mv(self.KT, w)

    def abs_row_max(self):
        return torch.amax(torch.abs(self.K), dim=1)

    def abs_col_max(self):
        return torch.amax(torch.abs(self.K), dim=0)

    def abs_row_sum(self):
        return torch.sum(torch.abs(self.K), dim=1)

    def abs_col_sum(self):
        return torch.sum(torch.abs(self.K), dim=0)

    def scaled(self, d1, d2) -> "DenseOp":
        return DenseOp(d1[:, None] * self.K * d2[None, :])


class SparseOp:
    """A COO operator: products gather and scatter-add its entries."""

    def __init__(self, row, col, val, shape):
        self.row, self.col, self.val = row, col, val
        self.shape = (int(shape[0]), int(shape[1]))

    def _scatter(self, index, values, size, how):
        out = torch.zeros(size, dtype=values.dtype, device=values.device)
        if how == "sum":
            return out.index_add_(0, index, values)
        return out.scatter_reduce_(0, index, values, "amax",
                                   include_self=True)

    def mv(self, v):
        return self._scatter(self.row, self.val * v[self.col],
                             self.shape[0], "sum")

    def rmv(self, w):
        return self._scatter(self.col, self.val * w[self.row],
                             self.shape[1], "sum")

    def abs_row_max(self):
        return self._scatter(self.row, torch.abs(self.val), self.shape[0],
                             "amax")

    def abs_col_max(self):
        return self._scatter(self.col, torch.abs(self.val), self.shape[1],
                             "amax")

    def abs_row_sum(self):
        return self._scatter(self.row, torch.abs(self.val), self.shape[0],
                             "sum")

    def abs_col_sum(self):
        return self._scatter(self.col, torch.abs(self.val), self.shape[1],
                             "sum")

    def scaled(self, d1, d2) -> "SparseOp":
        return SparseOp(self.row, self.col,
                        self.val * d1[self.row] * d2[self.col], self.shape)


def operator(K, dtype, device):
    """The reference's operator for a dense ndarray or a COO-like K
    (``data``, ``row``, ``col``, ``shape``)."""
    if hasattr(K, "row"):
        return SparseOp(torch.as_tensor(np.asarray(K.row, np.int64),
                                        device=device),
                        torch.as_tensor(np.asarray(K.col, np.int64),
                                        device=device),
                        torch.as_tensor(K.data, dtype=dtype, device=device),
                        K.shape)
    return DenseOp(torch.as_tensor(np.asarray(K), dtype=dtype,
                                   device=device))


def ruiz(op, iters: int = 10, eps: float = 1e-12):
    """Row and column scalings (d1, d2) with d1 K d2 near unit
    infinity norms."""
    m, n = op.shape
    dt, dev = op_dtype(op), op_device(op)
    d1 = torch.ones(m, dtype=dt, device=dev)
    d2 = torch.ones(n, dtype=dt, device=dev)
    cur = op
    for _ in range(iters):
        r = torch.sqrt(cur.abs_row_max())
        c = torch.sqrt(cur.abs_col_max())
        r = torch.where(r < eps, torch.ones_like(r), r)
        c = torch.where(c < eps, torch.ones_like(c), c)
        d1, d2 = d1 / r, d2 / c
        cur = op.scaled(d1, d2)
    return d1, d2, cur


def op_dtype(op):
    return op.K.dtype if isinstance(op, DenseOp) else op.val.dtype


def op_device(op):
    return op.K.device if isinstance(op, DenseOp) else op.val.device


@dataclasses.dataclass
class Scaled:
    """The Ruiz-scaled problem and its step diagonals."""

    op: object
    b: torch.Tensor
    c: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    d1: torch.Tensor
    d2: torch.Tensor
    T: torch.Tensor
    Sigma: torch.Tensor


def prepare(inst, dtype, device, ruiz_iters: int = 10) -> Scaled:
    op = operator(inst.K, dtype, device)

    def vec(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    d1, d2, sop = ruiz(op, ruiz_iters)
    lb, ub = vec(inst.lb), vec(inst.ub)
    lbs = torch.where(torch.isfinite(lb), lb / d2, lb)
    ubs = torch.where(torch.isfinite(ub), ub / d2, ub)
    T = 1.0 / torch.clamp(sop.abs_col_sum(), min=1e-12)
    Sigma = 1.0 / torch.clamp(sop.abs_row_sum(), min=1e-12)
    return Scaled(sop, d1 * vec(inst.b), d2 * vec(inst.c), lbs, ubs, d1, d2,
                  T, Sigma)


def power_norm(mv, rmv, n: int, dtype, device, iters: int = 100) -> float:
    """||A||_2 from ``iters`` rounds of v <- A^T A v (seeded start)."""
    g = torch.Generator(device="cpu").manual_seed(0)
    v = torch.randn(n, generator=g, dtype=dtype).to(device)
    v = v / torch.linalg.vector_norm(v)
    est = 0.0
    for _ in range(iters):
        w = rmv(mv(v))
        nw = torch.linalg.vector_norm(w)
        est = float(torch.sqrt(nw))
        v = w / nw
    return est


def residuals(s: Scaled, x, y, Kx, KTy):
    """``(r_pri, r_dual, r_gap)`` on the scaled problem (bounds-aware
    multipliers), as 0-d tensors."""
    norm = torch.linalg.vector_norm
    reduced = s.c - KTy
    has_lb, has_ub = torch.isfinite(s.lb), torch.isfinite(s.ub)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    lam_lo = torch.where(has_lb, torch.clamp(reduced, min=0.0), zero)
    lam_hi = torch.where(has_ub, torch.clamp(-reduced, min=0.0), zero)
    r_pri = norm(Kx - s.b) / (1.0 + norm(s.b))
    r_dual = norm(reduced - lam_lo + lam_hi) / (1.0 + norm(s.c))
    pobj = torch.dot(s.c, x)
    dobj = (torch.dot(s.b, y)
            + torch.sum(torch.where(has_lb, s.lb, zero) * lam_lo)
            - torch.sum(torch.where(has_ub, s.ub, zero) * lam_hi))
    r_gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj)
                                      + torch.abs(dobj))
    return r_pri, r_dual, r_gap


def merit(s: Scaled, x, y, Kx, KTy):
    """max(r_pri, r_dual, r_gap), as a 0-d tensor."""
    r_pri, r_dual, r_gap = residuals(s, x, y, Kx, KTy)
    return torch.maximum(torch.maximum(r_pri, r_dual), r_gap)


@dataclasses.dataclass
class Solution:
    x: np.ndarray           # original coordinates, float64 on the host
    y: np.ndarray
    iterations: int
    merit: float
    status: str             # "optimal" | "iteration_limit" | "diverged"


def solve_scaled(s: Scaled, *, tol: float, max_iters: int,
                 check_every: int = 100, eta: float = 0.95,
                 restart_beta: float = 0.5) -> Solution:
    """The loop on a prepared problem."""
    fwd, adj = s.op.mv, s.op.rmv
    m, n = s.op.shape
    dt, dev = s.b.dtype, s.b.device
    sq_s, sq_t = torch.sqrt(s.Sigma), torch.sqrt(s.T)
    norm = 1.05 * power_norm(lambda v: sq_s * fwd(sq_t * v),
                             lambda w: sq_t * adj(sq_s * w), n, dt, dev)
    tau = sigma = eta / norm
    x = torch.clamp(torch.zeros(n, dtype=dt, device=dev), s.lb, s.ub)
    y = torch.zeros(m, dtype=dt, device=dev)
    x_bar = x
    xs, ys, cnt = torch.zeros_like(x), torch.zeros_like(y), 0
    m_restart = math.inf
    it, status, cur = 0, "iteration_limit", math.inf
    tauT, sigmaS = tau * s.T, sigma * s.Sigma
    while it < max_iters:
        for _ in range(check_every):
            y = y + sigmaS * (s.b - fwd(x_bar))
            x_new = torch.clamp(x - tauT * (s.c - adj(y)), s.lb, s.ub)
            x_bar = 2.0 * x_new - x
            x = x_new
            xs, ys = xs + x, ys + y
        it += check_every
        cnt += check_every
        cur = float(merit(s, x, y, fwd(x), adj(y)))
        xa, ya = xs / cnt, ys / cnt
        avg = float(merit(s, xa, ya, fwd(xa), adj(ya)))
        if not (math.isfinite(cur) and math.isfinite(avg)):
            status = "diverged"
            break
        restart = avg < restart_beta * m_restart
        if avg <= tol or (restart and avg < cur):
            x, x_bar, y, cur = xa, xa, ya, avg
        if restart:
            m_restart = min(avg, cur)
            xs, ys, cnt = torch.zeros_like(x), torch.zeros_like(y), 0
        if cur <= tol:
            status = "optimal"
            break
    x_orig = (s.d2 * x).double().cpu().numpy()
    y_orig = (s.d1 * y).double().cpu().numpy()
    return Solution(x_orig, y_orig, it, cur, status)


def solve(inst, *, dtype=torch.float64, device="cpu", tol: float = 1e-6,
          max_iters: int = 40000, check_every: int = 100) -> Solution:
    """Solve one LP (a dense or COO ``K``) in ``dtype`` on ``device``."""
    s = prepare(inst, dtype, device)
    return solve_scaled(s, tol=tol, max_iters=max_iters,
                        check_every=check_every)
