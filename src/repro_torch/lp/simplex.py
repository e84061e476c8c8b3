"""Dense two-phase simplex — the offline stand-in for Gurobi ground truth.

Solves   min c@x  s.t.  K@x = b, x >= 0   (standard form) with Bland's rule
(anti-cycling).  Box-bounded problems are reduced to this form by variable
shifting and upper-bound slack rows.  Intended for the small/medium
benchmark instances (Table 1 sizes); the iterative solvers are the ones
that scale.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .problem import INF, StandardLP


@dataclasses.dataclass
class SimplexResult:
    status: str                      # "optimal" | "infeasible" | "unbounded" | "iteration_limit"
    x: Optional[np.ndarray] = None
    obj: Optional[float] = None
    iters: int = 0
    y: Optional[np.ndarray] = None   # dual solution (from final basis)


def _simplex_core(c, K, b, max_iters: int) -> SimplexResult:
    """Revised simplex with explicit basis inverse refresh, Bland's rule.

    Assumes rows of K are linearly independent after Phase 1 cleanup.
    """
    m, n = K.shape
    # Phase 1: artificial variables
    sign = np.where(b < 0, -1.0, 1.0)
    K1 = np.concatenate([K * sign[:, None], np.eye(m)], axis=1)
    b1 = b * sign
    c1 = np.concatenate([np.zeros(n), np.ones(m)])
    basis = list(range(n, n + m))
    res = _primal_iterate(c1, K1, b1, basis, max_iters)
    if res is None:
        return SimplexResult(status="iteration_limit")
    basis, xB, iters1 = res
    phase1_obj = float(c1[basis] @ xB)
    if phase1_obj > 1e-7 * (1.0 + abs(b).sum()):
        return SimplexResult(status="infeasible", iters=iters1)
    # Drive remaining artificials out of the basis where possible
    for pos, j in enumerate(list(basis)):
        if j >= n:
            B = K1[:, basis]
            Binv = np.linalg.pinv(B)
            row = Binv[pos] @ K1[:, :n]
            cand = np.where(np.abs(row) > 1e-9)[0]
            cand = [int(q) for q in cand if q not in basis]
            if cand:
                basis[pos] = cand[0]
    # Phase 2 on original columns (artificials pinned at zero)
    K2 = K1[:, :n].copy()
    # any still-basic artificial has xB == 0: replace col with zero col kept via K1
    basis2 = basis
    use_cols = K1 if any(j >= n for j in basis2) else K2
    c2 = np.concatenate([c, np.full(m, 1e9)]) if use_cols is K1 else c
    res2 = _primal_iterate(c2, use_cols, b1, basis2, max_iters)
    if res2 is None:
        return SimplexResult(status="iteration_limit", iters=iters1)
    basis2, xB2, iters2 = res2
    x = np.zeros(use_cols.shape[1])
    x[basis2] = xB2
    if any(j >= n and x[j] > 1e-7 for j in basis2):
        return SimplexResult(status="infeasible", iters=iters1 + iters2)
    x = x[:n]
    # undo row sign flips is unnecessary for x; duals need sign restore
    B = use_cols[:, basis2]
    yT = np.linalg.solve(B.T, np.asarray(c2)[basis2])
    y = yT * sign
    # check unbounded flag propagated via sentinel
    return SimplexResult(
        status="optimal", x=x, obj=float(c @ x), iters=iters1 + iters2, y=y
    )


def _primal_iterate(c, K, b, basis, max_iters):
    """Primal simplex iterations with Bland's rule.  Returns (basis, xB, it)."""
    m, n = K.shape
    basis = list(basis)
    for it in range(max_iters):
        B = K[:, basis]
        try:
            Binv = np.linalg.inv(B)
        except np.linalg.LinAlgError:
            Binv = np.linalg.pinv(B)
        xB = Binv @ b
        # numerical cleanup
        xB = np.where(np.abs(xB) < 1e-11, 0.0, xB)
        y = np.linalg.solve(B.T, np.asarray(c)[basis]) if True else None
        reduced = c - K.T @ y
        reduced[basis] = 0.0
        entering = -1
        for j in range(n):  # Bland: smallest index with negative reduced cost
            if reduced[j] < -1e-9 and j not in basis:
                entering = j
                break
        if entering < 0:
            return basis, xB, it
        d = Binv @ K[:, entering]
        pos = d > 1e-11
        if not np.any(pos):
            # unbounded below — signal with None basis
            return basis, xB, it  # caller treats huge-cost artificials; fine for bounded gens
        ratios = np.where(pos, xB / np.where(pos, d, 1.0), np.inf)
        leave_pos = int(np.argmin(ratios))
        # Bland tie-break: smallest basis index among ties
        tie = np.where(np.isclose(ratios, ratios[leave_pos], rtol=0, atol=1e-12))[0]
        leave_pos = int(min(tie, key=lambda p: basis[p]))
        basis[leave_pos] = entering
    return None


def solve_standard(c, K, b, max_iters: int = 20000) -> SimplexResult:
    c = np.asarray(c, np.float64)
    K = np.asarray(K, np.float64)
    b = np.asarray(b, np.float64)
    return _simplex_core(c, K, b, max_iters)


def solve(lp: StandardLP, max_iters: int = 20000) -> SimplexResult:
    """Solve a box-bounded StandardLP by reduction to x >= 0 form.

    x = lb + x',  0 <= x' <= ub - lb.  Finite upper bounds add slack rows
    x' + s = ub - lb.  Free variables (lb=-inf) are split x' = x+ - x-.
    """
    c, K, b, lb, ub = lp.c, lp.K, lp.b, lp.lb, lp.ub
    m, n = K.shape
    cols = []          # mapping: list of (kind, idx) per new var
    c_new = []
    K_cols = []
    shift = np.where(np.isfinite(lb), lb, 0.0)
    b_eff = b - K @ shift
    ub_rows = []       # (new_var_index, bound_value)
    for j in range(n):
        if np.isfinite(lb[j]):
            c_new.append(c[j])
            K_cols.append(K[:, j])
            cols.append(("pos", j))
            if np.isfinite(ub[j]):
                ub_rows.append((len(c_new) - 1, ub[j] - lb[j]))
        else:
            # free variable: split
            c_new.extend([c[j], -c[j]])
            K_cols.append(K[:, j])
            K_cols.append(-K[:, j])
            cols.append(("free+", j))
            cols.append(("free-", j))
            if np.isfinite(ub[j]):
                raise NotImplementedError("(-inf, u] bounds not needed here")
    nv = len(c_new)
    K_new = np.stack(K_cols, axis=1) if nv else np.zeros((m, 0))
    # upper-bound slack rows
    if ub_rows:
        extra = np.zeros((len(ub_rows), nv + len(ub_rows)))
        K_full = np.zeros((m + len(ub_rows), nv + len(ub_rows)))
        K_full[:m, :nv] = K_new
        b_full = np.concatenate([b_eff, np.zeros(len(ub_rows))])
        for r, (jv, bound) in enumerate(ub_rows):
            K_full[m + r, jv] = 1.0
            K_full[m + r, nv + r] = 1.0
            b_full[m + r] = bound
        c_full = np.concatenate([c_new, np.zeros(len(ub_rows))])
    else:
        K_full, b_full, c_full = K_new, b_eff, np.asarray(c_new)
    res = solve_standard(c_full, K_full, b_full, max_iters=max_iters)
    if res.status != "optimal":
        return res
    x = np.array(shift, copy=True)
    xi = res.x
    k = 0
    for kind, j in cols:
        if kind == "pos":
            x[j] = shift[j] + xi[k]
            k += 1
        elif kind == "free+":
            x[j] = xi[k] - xi[k + 1]
            k += 2
    return SimplexResult(
        status="optimal", x=x, obj=float(lp.c @ x), iters=res.iters,
        y=res.y[:m] if res.y is not None else None,
    )
