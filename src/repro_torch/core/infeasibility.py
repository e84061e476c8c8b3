"""Infeasibility certificates from PDHG iterate sequences (paper §2.3);
a numpy-only copy of ``repro.core.infeasibility``.

Following Applegate et al. [51], the difference sequence
d_k = z_{k+1} - z_k (and the normalized average iterate) converges to a
ray whose dual part is a Farkas certificate when the primal is infeasible:

    y with  K^T y <= 0 (componentwise, on coordinates with finite lb only;
                        here: standard form x >= 0)  and  b^T y > 0
    certifies  {x >= 0 : Kx = b} = empty.

We expose a checker over a candidate ray; the host solver feeds it the
difference iterate when divergence is detected.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Certificate:
    kind: str            # "primal_infeasible" | "none"
    violation: float     # max(K^T y)_+ (should be ~0 for a valid cert)
    improvement: float   # b^T y (should be > 0)
    y_ray: np.ndarray | None = None


def check_farkas(K, b, y_ray, tol: float = 1e-6) -> Certificate:
    """Is y_ray a (normalized) Farkas certificate of primal infeasibility?"""
    y = np.asarray(y_ray, dtype=np.float64)
    nrm = np.linalg.norm(y)
    if nrm < tol:
        return Certificate("none", np.inf, 0.0)
    y = y / nrm
    KTy = np.asarray(K).T @ y
    violation = float(np.maximum(KTy, 0.0).max(initial=0.0))
    improvement = float(np.asarray(b) @ y)
    ok = violation <= tol * 10 and improvement > tol
    return Certificate(
        "primal_infeasible" if ok else "none",
        violation=violation,
        improvement=improvement,
        y_ray=y,
    )


def difference_ray(z_hist: np.ndarray) -> np.ndarray:
    """Average difference direction 2*avg(z_k - z_0)/(k+1) (paper §2.3)."""
    z_hist = np.asarray(z_hist)
    k = z_hist.shape[0] - 1
    if k < 1:
        return np.zeros_like(z_hist[0])
    zbar = (z_hist[-1] - z_hist[0]) / 2.0
    return 2.0 * zbar / (k + 1)
