"""Symmetric block-matrix formulation (paper Algorithms 1 & 2); the port
of ``repro.core.symblock``.

    M = [[0_{m x m}, K       ],
         [K^T,       0_{n x n}]]

is encoded to the accelerator ONCE; every MVM the solver needs is a
single device MVM against M with mode-dependent zero padding / slicing:

    full : w = M @ u                       (Lanczos)
    A@x  : t = K @ x    = (M @ [0; x])[:m]  (dual step)
    AT@y : s = K^T @ y  = (M @ [y; 0])[m:]  (primal step)

``Accel`` abstracts *where* the single MVM runs: exact, noisy-model, or
the crossbar simulation with its CUDA kernel.  Each backend provides
``mvm_full(v)``; a stochastic backend draws its noise from a
``torch.Generator`` it owns, where the reference threads PRNG keys.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

MODE_FULL = "full"
MODE_AX = "A@x"
MODE_ATY = "AT@y"


def build_sym_block(K) -> torch.Tensor:
    """Algorithm 1 (BUILDSYMBLOCK), host step: M from K (m x n)."""
    m, n = K.shape
    M = torch.zeros((m + n, m + n), dtype=K.dtype, device=K.device)
    M[:m, m:] = K
    M[m:, :m] = K.T
    return M


@dataclasses.dataclass
class Accel:
    """Encoded accelerator handle (result of Algorithm 1 step 2).

    mvm_full: v (m+n,) -> M @ v.  May be stochastic (device noise, drawn
    from the backend's own generator)."""

    mvm_full: Callable[[torch.Tensor], torch.Tensor]
    m: int
    n: int
    name: str = "exact"
    # Number of device MVMs issued (host-side bookkeeping for the energy
    # ledger; incremented by matmul_accel).
    stats: Optional[dict] = None

    def __post_init__(self):
        if self.stats is None:
            self.stats = {"mvm_calls": 0}


def encode_exact(K, dtype=None) -> Accel:
    """Reference backend: encode M as a dense tensor, exact arithmetic."""
    K = torch.as_tensor(K, dtype=dtype)
    m, n = K.shape
    M = build_sym_block(K)

    def mvm(v):
        return torch.mv(M, v)

    return Accel(mvm_full=mvm, m=m, n=n, name="exact")


def encode_noisy(K, noise_apply, generator: Optional[torch.Generator] = None,
                 dtype=None) -> Accel:
    """Backend with an explicit MVM perturbation model (Assumptions 1-4).

    ``noise_apply(generator, w) -> w_noisy`` is applied to the exact
    product, drawing from ``generator`` (``None``: exact products).
    Models ``M v + zeta`` with E[zeta] = 0."""
    K = torch.as_tensor(K, dtype=dtype)
    m, n = K.shape
    M = build_sym_block(K)

    def mvm(v):
        w = torch.mv(M, v)
        if generator is None:
            return w
        return noise_apply(generator, w)

    return Accel(mvm_full=mvm, m=m, n=n, name="noisy")


def matmul_accel(accel: Accel, u, mode: str) -> torch.Tensor:
    """Algorithm 2 (MATMULACCEL): pad -> single device MVM -> slice."""
    m, n = accel.m, accel.n
    if mode == MODE_FULL:
        v = u
    elif mode == MODE_AX:
        v = torch.cat([torch.zeros(m, dtype=u.dtype, device=u.device), u])
    elif mode == MODE_ATY:
        v = torch.cat([u, torch.zeros(n, dtype=u.dtype, device=u.device)])
    else:
        raise ValueError(f"unknown mode {mode!r}")
    w = accel.mvm_full(v)
    accel.stats["mvm_calls"] += 1
    if mode == MODE_FULL:
        return w
    if mode == MODE_AX:
        return w[:m]          # t = K x
    return w[m:]              # s = K^T y


def scaled_accel(accel: Accel, row_scale, col_scale, name=None) -> Accel:
    """Diagonal similarity wrap: M' = D M D with D = diag(row_scale,
    col_scale).

    Evaluates the *preconditioned* operator norm ||Sigma^1/2 K T^1/2||_2
    without reprogramming the device: diag(Sigma^1/2, T^1/2) M
    diag(Sigma^1/2, T^1/2) is exactly the symmetric block of
    Sigma^1/2 K T^1/2.  Host-side vector scaling only."""
    d = torch.cat([row_scale, col_scale])

    def mvm(v):
        return d * accel.mvm_full(d * v)

    return Accel(mvm_full=mvm, m=accel.m, n=accel.n,
                 name=name or f"scaled({accel.name})", stats=accel.stats)


def as_dense(accel: Accel, dtype=torch.float64, device=None) -> np.ndarray:
    """Materialize M by probing (test helper; O(m+n) MVMs)."""
    dim = accel.m + accel.n
    eye = torch.eye(dim, dtype=dtype, device=device)
    cols = [accel.mvm_full(eye[:, i]).cpu().numpy() for i in range(dim)]
    return np.stack(cols, axis=1)
