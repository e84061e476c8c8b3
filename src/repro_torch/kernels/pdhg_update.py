"""Fused PDHG vector updates: CUDA kernels B1/B2 and their plain versions.

    dual:    y_new = y + σ·Σ⊙(b − Kx̄)
    primal:  x_new = clip(x − τ·T⊙(c − Kᵀy), lb, ub)
             x̄    = x_new + θ·(x_new − x)        (extrapolation for k+1)

Ports of ``repro/kernels/pdhg_update.py::_dual_kernel`` and
``::_primal_kernel``.  The kernels are in ``csrc/pdhg_kernels.cu``
(``dual_update_kernel``/``primal_update_kernel``), which also says what
bounds them on the H100.  σ, τ and θ are 0-d tensors read by the kernel
through a device pointer, so a step size that changes every step (the
``strongly_convex`` θ-schedule) never costs a host sync.

``dual_update``/``primal_update`` launch the kernel for CUDA tensors and
take the plain version for CPU tensors, and only for them; each counts
its kernel launches in ``.launches``.
"""
from __future__ import annotations

import torch

from . import _build


def dual_update_plain(y, kxbar, b, Sigma, sigma):
    """Plain PyTorch version of the dual update (the kernel's oracle)."""
    return y + sigma * Sigma * (b - kxbar)


def primal_update_plain(x, kty, c, T, lb, ub, tau, theta):
    """Plain PyTorch version of the primal update; returns (x_new, x̄)."""
    x_new = torch.clamp(x - tau * T * (c - kty), lb, ub)
    return x_new, x_new + theta * (x_new - x)


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"repro_torch kernels run on CUDA (or, as their "
                         f"plain version, on the CPU); got {t.device}")
    return False


def _check_vectors(length: int, *vecs: torch.Tensor) -> None:
    for v in vecs:
        if v.shape != (length,):
            raise ValueError(f"expected a ({length},) vector, got "
                             f"{tuple(v.shape)}")


def _check_scalars(*scalars: torch.Tensor) -> None:
    for s in scalars:
        if s.numel() != 1:
            raise ValueError(f"step sizes are 0-d tensors, got shape "
                             f"{tuple(s.shape)}")


def dual_update(y, kxbar, b, Sigma, sigma):
    """B1: ``y + sigma * Sigma * (b - kxbar)``; ``sigma`` a 0-d tensor."""
    if _on_cpu(y):
        return dual_update_plain(y, kxbar, b, Sigma, sigma)
    _build.check_cuda_operands(y, kxbar, b, Sigma, sigma)
    _check_vectors(y.shape[0], y, kxbar, b, Sigma)
    _check_scalars(sigma)
    out = torch.empty_like(y)
    _build.launch("pdhg_dual_update", y.dtype, y.data_ptr(),
                  kxbar.data_ptr(), b.data_ptr(), Sigma.data_ptr(),
                  sigma.data_ptr(), out.data_ptr(), y.shape[0])
    dual_update.launches += 1
    return out


def primal_update(x, kty, c, T, lb, ub, tau, theta):
    """B2: returns ``(x_new, x_bar)``; ``tau``/``theta`` 0-d tensors and
    the bounds may be ±inf."""
    if _on_cpu(x):
        return primal_update_plain(x, kty, c, T, lb, ub, tau, theta)
    _build.check_cuda_operands(x, kty, c, T, lb, ub, tau, theta)
    _check_vectors(x.shape[0], x, kty, c, T, lb, ub)
    _check_scalars(tau, theta)
    x_new = torch.empty_like(x)
    x_bar = torch.empty_like(x)
    _build.launch("pdhg_primal_update", x.dtype, x.data_ptr(),
                  kty.data_ptr(), c.data_ptr(), T.data_ptr(), lb.data_ptr(),
                  ub.data_ptr(), tau.data_ptr(), theta.data_ptr(),
                  x_new.data_ptr(), x_bar.data_ptr(), x.shape[0])
    primal_update.launches += 1
    return x_new, x_bar


dual_update.launches = 0
primal_update.launches = 0
