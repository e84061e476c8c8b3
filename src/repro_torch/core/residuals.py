"""KKT residuals and stopping rule (paper §3.3, eqs. 9-11); the port of
``repro.core.residuals``.

r_pri  = ||K x - b|| / (1 + ||b||)
r_dual = ||c - K^T y - lambda|| / (1 + ||c||),   lambda = [c - K^T y]_+
r_iter = ||[x_k - x_{k+1}]_+|| / (1 + ||x_{k+1}||)
r_gap  = |c^T x - b^T y| / (1 + |c^T x| + |b^T y|)

The residuals reuse already-computed MVM products; every value stays a
0-d tensor on the device, so a check costs no host sync by itself.
With a leading batch axis ((B, d) vectors) every residual is a (B,)
tensor, one per lane.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KKTResiduals:
    r_pri: torch.Tensor
    r_dual: torch.Tensor
    r_iter: torch.Tensor
    r_gap: torch.Tensor

    @property
    def max(self):
        return torch.maximum(
            torch.maximum(self.r_pri, self.r_dual),
            torch.maximum(self.r_iter, self.r_gap),
        )

    def converged(self, tol: float):
        return self.max <= tol

    def as_dict(self):
        return {
            "r_pri": float(self.r_pri),
            "r_dual": float(self.r_dual),
            "r_iter": float(self.r_iter),
            "r_gap": float(self.r_gap),
        }


def kkt_residuals(
    x, x_prev, y, c, b, Kx, KTy, lb=None, ub=None
) -> KKTResiduals:
    """The four residuals from already-available MVM products ``Kx`` and
    ``KTy``; finite ``lb``/``ub`` entries carry bound multipliers (with
    lb=0, ub=inf this is the paper's lambda = [c - K^T y]_+)."""
    reduced = c - KTy
    zero = torch.zeros((), dtype=reduced.dtype, device=reduced.device)
    if lb is None and ub is None:
        lam_lo = torch.clamp(reduced, min=0.0)
        lam_hi = torch.zeros_like(reduced)
        lam = lam_lo
        lb_fin = ub_fin = None
    else:
        no = torch.zeros_like(reduced, dtype=torch.bool)
        has_lb = torch.isfinite(lb) if lb is not None else no
        has_ub = torch.isfinite(ub) if ub is not None else no
        lam_lo = torch.where(has_lb, torch.clamp(reduced, min=0.0), zero)
        lam_hi = torch.where(has_ub, torch.clamp(-reduced, min=0.0), zero)
        lam = lam_lo - lam_hi
        lb_fin = torch.where(has_lb, lb if lb is not None else zero, zero)
        ub_fin = torch.where(has_ub, ub if ub is not None else zero, zero)
    if x.dim() == 1:
        norm, dot = torch.linalg.vector_norm, torch.dot
    else:
        def norm(v):
            return torch.linalg.vector_norm(v, dim=-1)

        def dot(u, v):
            return torch.sum(u * v, dim=-1)
    r_pri = norm(Kx - b) / (1.0 + norm(b))
    r_dual = norm(reduced - lam) / (1.0 + norm(c))
    r_iter = norm(torch.clamp(x_prev - x, min=0.0)) / (1.0 + norm(x))
    pobj = dot(c, x)
    # bounds-aware dual objective: b^T y + lb^T lam_lo - ub^T lam_hi
    dobj = dot(b, y)
    if lb_fin is not None:
        dobj = dobj + dot(lb_fin, lam_lo) - dot(ub_fin, lam_hi)
    r_gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj) + torch.abs(dobj))
    return KKTResiduals(r_pri=r_pri, r_dual=r_dual, r_iter=r_iter, r_gap=r_gap)


def relative_error(z, z_star):
    """Paper eq. 13: Delta_rel = |z - z*| / |z| (z = ground truth)."""
    return abs(z - z_star) / max(abs(z), 1e-300)
