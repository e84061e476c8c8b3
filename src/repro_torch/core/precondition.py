"""Model preparation (paper §2.3 / Algorithm 4 Step 0); the port of
``repro.core.precondition``.

* Ruiz rescaling [48]: iterative row/col infinity-norm equilibration,
  K~ = D1 K D2.
* Pock–Chambolle diagonal preconditioning [49]: T_j = 1 / sum_i
  |K_ij|^{2-a}, Sigma_i = 1 / sum_j |K_ij|^a (a = 1), which guarantee
  ||Sigma^{1/2} K T^{1/2}||_2 <= 1.

Both run on the tensors' own device, on one (m, n) K or a (B, m, n)
stack of them (row and column reductions along the last two axes).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class ScaledProblem:
    """Ruiz-rescaled problem data (Algorithm 4 lines 2-4)."""

    K: torch.Tensor       # D1 K D2
    b: torch.Tensor       # D1 b
    c: torch.Tensor       # D2 c
    lb: torch.Tensor      # D2^{-1} lb
    ub: torch.Tensor      # D2^{-1} ub
    D1: torch.Tensor      # (m,) row scaling diag
    D2: torch.Tensor      # (n,) col scaling diag

    def unscale_x(self, x):
        return self.D2 * x

    def unscale_y(self, y):
        return self.D1 * y


def ruiz_rescale(K, iters: int = 10,
                 eps: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ruiz equilibration: returns (D1, D2) with D1 K D2 ~ unit inf-norms."""
    lead, (m, n) = K.shape[:-2], K.shape[-2:]
    one = torch.ones((), dtype=K.dtype, device=K.device)
    D1 = torch.ones((*lead, m), dtype=K.dtype, device=K.device)
    D2 = torch.ones((*lead, n), dtype=K.dtype, device=K.device)
    Kw = K
    for _ in range(iters):
        absK = torch.abs(Kw)
        r = torch.sqrt(torch.amax(absK, dim=-1))
        c = torch.sqrt(torch.amax(absK, dim=-2))
        del absK
        r = torch.where(r < eps, one, r)
        c = torch.where(c < eps, one, c)
        D1 = D1 / r
        D2 = D2 / c
        Kw = K * D1[..., :, None] * D2[..., None, :]
    return D1, D2


def apply_ruiz(K, b, c, lb, ub, iters: int = 10) -> ScaledProblem:
    D1, D2 = ruiz_rescale(K, iters=iters)
    Ks = K * D1[..., :, None] * D2[..., None, :]
    # x = D2 x~  =>  bounds on x~ are D2^{-1}-scaled; +-inf preserved.
    lbs = torch.where(torch.isfinite(lb), lb / D2, lb)
    ubs = torch.where(torch.isfinite(ub), ub / D2, ub)
    return ScaledProblem(K=Ks, b=D1 * b, c=D2 * c, lb=lbs, ub=ubs,
                         D1=D1, D2=D2)


def diagonal_precondition(K, alpha: float = 1.0, eps: float = 1e-12):
    """Pock–Chambolle diagonals: (T primal (n,), Sigma dual (m,))."""
    absK = torch.abs(K)
    col = torch.sum(absK ** (2.0 - alpha), dim=-2)  # per primal coordinate
    row = torch.sum(absK ** alpha, dim=-1)          # per dual coordinate
    T = 1.0 / torch.clamp(col, min=eps)
    Sigma = 1.0 / torch.clamp(row, min=eps)
    return T, Sigma
