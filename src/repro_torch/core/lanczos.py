"""Operator-norm estimation (paper §3.2, Algorithm 3); the port of
``repro.core.lanczos``.

Proposition 1: lambda_max(M) == sigma_max(K), so a Lanczos run on the
symmetric block M estimates ||K||_2 with ONE MVM per iteration.

  * ``lanczos_svd``      — host loop over an ``Accel`` backend (crossbar
                           simulation, energy ledger), early exit.
  * ``lanczos_svd_jit``  — fixed iterations, no host read per step.

Every estimator takes ``v0=`` so that a caller can inject the start
vector; by default it is drawn from a CPU ``torch.Generator`` (seeded
with 0, or the caller's seed), so that CPU and CUDA runs start from the
same vector.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .symblock import MODE_FULL, Accel, matmul_accel

# norm estimators selectable by ``PDHGOptions.norm_backend``; both cost
# ONE symmetric-block MVM per iteration
NORM_BACKENDS = ("lanczos", "power")


def default_start(dim: int, dtype, device, seed: int = 0) -> torch.Tensor:
    """The reproducible default start vector (seeded, drawn on the CPU)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(dim, generator=g, dtype=dtype).to(device)


def _start(v0, dim, dtype, device, seed: int = 0):
    if v0 is None:
        return default_start(dim, dtype, device, seed)
    return torch.as_tensor(v0, dtype=dtype, device=device)


@dataclasses.dataclass
class LanczosResult:
    sigma_max: float          # estimated dominant singular value of K
    iterations: int
    alphas: np.ndarray
    betas: np.ndarray
    ritz_history: np.ndarray  # largest Ritz value after each iteration
    ergodic_estimate: float   # mean of ritz_history (Theorem 1 estimator)


def lanczos_svd(
    accel: Accel,
    k_max: int = 64,
    tol: float = 1e-8,
    v0=None,
    reorthogonalize: bool = True,
    seed: int = 0,
    dtype=torch.float64,
    device=None,
) -> LanczosResult:
    """Algorithm 3 (LanczosSVD) on the encoded symmetric block M.

    One full-vector device MVM per iteration, and two host reads
    (alpha, beta) with a host ``eigvalsh`` of the tridiagonal matrix.
    ``reorthogonalize`` applies full re-orthogonalization against all
    previous basis vectors (the paper's Lemma 1 setting, essential under
    device noise).  ``v0`` injects the start vector before
    normalisation; by default it is drawn from a CPU generator seeded
    with ``seed``, in ``dtype``, and moved to ``device``."""
    v = _start(v0, accel.m + accel.n, dtype, device, seed)
    v = v / torch.linalg.vector_norm(v)
    v_prev = torch.zeros_like(v)
    beta = 0.0
    alphas, betas, ritz_hist = [], [], []
    basis = [v]
    eps = float(torch.finfo(v.dtype).eps)
    for _ in range(k_max):
        w = matmul_accel(accel, v, MODE_FULL)
        w = w - beta * v_prev
        alpha = float(torch.dot(v, w))
        w = w - alpha * v
        if reorthogonalize:
            for q in basis:
                w = w - torch.dot(q, w) * q
        beta_next = float(torch.linalg.vector_norm(w))
        alphas.append(alpha)
        betas.append(beta_next)
        T = _tridiag(alphas, betas[:-1])
        ritz = float(np.max(np.abs(np.linalg.eigvalsh(T))))
        ritz_hist.append(ritz)
        # breakdown when beta hits the requested tol OR the roundoff
        # floor of the working dtype
        if beta_next < max(tol, 8.0 * eps * max(ritz, 1.0)):
            break
        v_prev = v
        v = w / beta_next
        basis.append(v)
        beta = beta_next
    ritz_hist = np.asarray(ritz_hist)
    return LanczosResult(
        sigma_max=float(ritz_hist[-1]),
        iterations=len(alphas),
        alphas=np.asarray(alphas),
        betas=np.asarray(betas),
        ritz_history=ritz_hist,
        ergodic_estimate=float(ritz_hist.mean()),
    )


def _tridiag(alphas, betas) -> np.ndarray:
    k = len(alphas)
    T = np.zeros((k, k))
    T[np.arange(k), np.arange(k)] = alphas
    if k > 1:
        T[np.arange(k - 1), np.arange(1, k)] = betas
        T[np.arange(1, k), np.arange(k - 1)] = betas
    return T


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


def power_iteration(K: torch.Tensor, iters: int = 100,
                    v0=None) -> torch.Tensor:
    """Two-sided power iteration baseline (eq. 8): ||K||_2 estimate."""
    v = _start(v0, K.shape[1], K.dtype, K.device)
    v = v / torch.linalg.vector_norm(v)
    nw = None
    for _ in range(iters):
        w = torch.mv(K.T, torch.mv(K, v))
        nw = torch.linalg.vector_norm(w)
        v = w / nw
    return torch.sqrt(nw)
