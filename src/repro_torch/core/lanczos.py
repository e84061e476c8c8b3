"""Operator-norm estimation (paper §3.2, Algorithm 3); the port of the
fixed-iteration estimators of ``repro.core.lanczos``.

Proposition 1: lambda_max(M) == sigma_max(K), so a Lanczos run on the
symmetric block M estimates ||K||_2 with ONE MVM per iteration.  Both
estimators take ``v0=`` so that a caller can inject the start vector;
by default it is drawn from a CPU ``torch.Generator`` seeded with 0, so
that CPU and CUDA runs start from the same vector.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

# norm estimators selectable by ``PDHGOptions.norm_backend``; both cost
# ONE symmetric-block MVM per iteration
NORM_BACKENDS = ("lanczos", "power")


def default_start(dim: int, dtype, device, seed: int = 0) -> torch.Tensor:
    """The reproducible default start vector (seeded, drawn on the CPU)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(dim, generator=g, dtype=dtype).to(device)


def _start(v0, dim, dtype, device):
    if v0 is None:
        return default_start(dim, dtype, device)
    return torch.as_tensor(v0, dtype=dtype, device=device)


def lanczos_svd_jit_mv(matvec: Callable, dim: int, dtype, k_max: int = 32,
                       v0=None, device=None) -> torch.Tensor:
    """Fixed-iteration Lanczos on an arbitrary symmetric matvec.

    Returns the largest |Ritz value| of the k_max-step
    tridiagonalization as a 0-d tensor on ``device``; no early exit
    (fixed cost).  Past an exact breakdown (``beta_next`` at the
    roundoff floor, e.g. ``dim < k_max``) the unnormalised remainder is
    carried on unless ``beta_next`` is at or below 1e-30, as in the
    reference."""
    v = _start(v0, dim, dtype, device)
    v = v / torch.linalg.vector_norm(v)
    v_prev = torch.zeros_like(v)
    beta = torch.zeros((), dtype=dtype, device=v.device)
    alphas, betas = [], []
    for _ in range(k_max):
        w = matvec(v)
        w = w - beta * v_prev
        alpha = torch.dot(v, w)
        w = w - alpha * v
        beta_next = torch.linalg.vector_norm(w)
        v_next = torch.where(beta_next > 1e-30, w / beta_next, w)
        v_prev, v, beta = v, v_next, beta_next
        alphas.append(alpha)
        betas.append(beta_next)
    a = torch.stack(alphas).cpu()
    b = torch.stack(betas).cpu()[:-1]
    T = torch.diag(a) + torch.diag(b, 1) + torch.diag(b, -1)
    return torch.max(torch.abs(torch.linalg.eigvalsh(T))).to(v.device)


def lanczos_svd_jit(M: torch.Tensor, k_max: int = 32,
                    v0=None) -> torch.Tensor:
    """Fixed-iteration Lanczos on a dense symmetric M."""
    return lanczos_svd_jit_mv(lambda v: torch.mv(M, v), M.shape[0], M.dtype,
                              k_max=k_max, v0=v0, device=M.device)


def power_iteration_mv(matvec: Callable, dim: int, dtype, iters: int = 64,
                       v0=None, device=None) -> torch.Tensor:
    """Fixed-iteration power method on a symmetric matvec (the
    ``norm_backend="power"`` twin of ``lanczos_svd_jit_mv``: same call
    shape, same one-MVM-per-iteration charge).  Returns the last growth
    factor ``||M v_k||``, which converges to sigma_max(K)."""
    v = _start(v0, dim, dtype, device)
    v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-30)
    nw: Optional[torch.Tensor] = None
    for _ in range(iters):
        w = matvec(v)
        nw = torch.linalg.vector_norm(w)
        v = w / torch.clamp(nw, min=1e-30)
    return nw
