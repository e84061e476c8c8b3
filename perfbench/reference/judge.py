"""The judge: what each answer of the window says, measured against the
benchmark's own instance in float64 on the host.

For an LP answer ``(x, y)`` in the original coordinates:

* ``kkt``: the largest of the relative primal residual ||K x - b|| /
  (1 + ||b||) (with any bound violation of x), the relative dual
  residual of the reduced costs c - K^T y against the bounds' signs,
  over 1 + ||c||, and the relative gap between c@x and the bounds-aware
  dual objective, over 1 + |c@x| + |dual|;
* ``obj``: |c@x - obj*| / max(|obj*|, 1), against the generator's known
  optimum;
* ``pri``, ``dual``, ``gap``: the three parts of ``kkt``, and ``x``:
  ||x - x*|| / ||x*||, against the generator's optimal x (unique: the
  construction is strictly complementary).

* ``merit``: the solver's stopping rule recomputed from the answer in
  the frame its tolerance is stated in: the reference's own Ruiz
  scaling of the instance (``pdhg.prepare``), then max(r_pri, r_dual,
  r_gap) of the scaled answer as ``pdhg.merit`` has them, and the
  scaled bound violation over 1 + ||b||.  An answer the program calls
  optimal reads at most the configuration's ``tol`` here.

* ``claim``: where the answer reports its residuals (r_pri, r_dual,
  r_gap of its x and y in the scaled frame, as ``solve_jit`` does), the
  largest gap between each and the reference's float64 recomputation,
  in units of the tolerance.  A float64 solve reports them to rounding;
  one in a lower precision reports them only as well as that precision
  computes them.

An answer that is missing, of the wrong length or not finite reads
``inf``.
"""
from __future__ import annotations

import math

import numpy as np

INF = math.inf


def _mv(K, v):
    if hasattr(K, "row"):
        return np.bincount(K.row, weights=K.data * v[K.col],
                           minlength=K.shape[0])
    return K @ v


def _rmv(K, w):
    if hasattr(K, "row"):
        return np.bincount(K.col, weights=K.data * w[K.row],
                           minlength=K.shape[1])
    return K.T @ w


def lp_readings(inst, x, y) -> dict:
    """``{"kkt": ..., "obj": ...}`` of one answer to ``inst``."""
    xy = _usable(inst, x, y)
    if xy is None:
        return dict.fromkeys(("kkt", "obj", "pri", "dual", "gap", "x"), INF)
    x, y = xy
    b, c, lb, ub = (np.asarray(a, np.float64)
                    for a in (inst.b, inst.c, inst.lb, inst.ub))
    norm = np.linalg.norm
    viol = np.maximum(lb - x, 0.0) + np.maximum(x - ub, 0.0)
    r_pri = math.hypot(norm(_mv(inst.K, x) - b), norm(viol)) / (1 + norm(b))
    reduced = c - _rmv(inst.K, y)
    has_lb, has_ub = np.isfinite(lb), np.isfinite(ub)
    lam_lo = np.where(has_lb, np.maximum(reduced, 0.0), 0.0)
    lam_hi = np.where(has_ub, np.maximum(-reduced, 0.0), 0.0)
    r_dual = norm(reduced - lam_lo + lam_hi) / (1 + norm(c))
    pobj = float(c @ x)
    dobj = float(b @ y + np.sum(np.where(has_lb, lb, 0.0) * lam_lo)
                 - np.sum(np.where(has_ub, ub, 0.0) * lam_hi))
    r_gap = abs(pobj - dobj) / (1 + abs(pobj) + abs(dobj))
    obj = abs(pobj - inst.obj_opt) / max(abs(inst.obj_opt), 1.0)
    out = {"kkt": max(r_pri, r_dual, r_gap), "obj": obj, "pri": r_pri,
           "dual": r_dual, "gap": r_gap}
    if inst.x_opt is not None:
        out["x"] = norm(x - inst.x_opt) / max(norm(inst.x_opt), 1e-300)
    return out


def _usable(inst, x, y):
    m, n = inst.shape
    if x is None or y is None:
        return None
    x = np.asarray(x, np.float64).reshape(-1)
    y = np.asarray(y, np.float64).reshape(-1)
    if x.shape != (n,) or y.shape != (m,) or not (
            np.all(np.isfinite(x)) and np.all(np.isfinite(y))):
        return None
    return x, y


def scaled_merit(s, inst, x, y) -> float:
    """``merit`` of one answer; ``s`` is ``pdhg.prepare(inst, float64,
    ...)``."""
    import torch

    from . import pdhg

    xy = _usable(inst, x, y)
    if xy is None:
        return INF
    xt = torch.as_tensor(xy[0], device=s.b.device) / s.d2
    yt = torch.as_tensor(xy[1], device=s.b.device) / s.d1
    viol = (torch.clamp(s.lb - xt, min=0.0)
            + torch.clamp(xt - s.ub, min=0.0))
    bounds = float(torch.linalg.vector_norm(viol)
                   / (1.0 + torch.linalg.vector_norm(s.b)))
    return max(float(pdhg.merit(s, xt, yt, s.op.mv(xt), s.op.rmv(yt))),
               bounds)


def claim_gap(s, inst, x, y, claimed: dict, tol: float) -> float:
    """``claim`` of one answer; ``s`` as for ``scaled_merit``."""
    import torch

    from . import pdhg

    xy = _usable(inst, x, y)
    if xy is None or not claimed:
        return INF
    xt = torch.as_tensor(xy[0], device=s.b.device) / s.d2
    yt = torch.as_tensor(xy[1], device=s.b.device) / s.d1
    ours = pdhg.residuals(s, xt, yt, s.op.mv(xt), s.op.rmv(yt))
    return max(abs(float(claimed[k]) - float(v)) for k, v in
               zip(("r_pri", "r_dual", "r_gap"), ours)) / tol


def worst(readings, key: str) -> float:
    """The largest reading of ``key`` (``inf`` where there is none)."""
    vals = [r[key] for r in readings]
    return max(vals) if vals else INF
