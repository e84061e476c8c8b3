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

Both take an optional leading batch axis: vectors ``(B, d)`` with step
sizes of shape ``(B,)`` (one per lane), run by one launch; a single
instance is ``(d,)`` vectors with 0-d step sizes.
"""
from __future__ import annotations

import torch

from . import _build


def per_lane(s, v):
    """A step size against vectors ``v``: a (B,) tensor of per-lane
    values becomes (B, 1) against (B, d) vectors; anything else (a 0-d
    tensor, a number) is returned as it is."""
    if torch.is_tensor(s) and 0 < s.dim() == v.dim() - 1:
        return s.unsqueeze(-1)
    return s


def dual_update_plain(y, kxbar, b, Sigma, sigma):
    """Plain PyTorch version of the dual update (the kernel's oracle)."""
    return y + per_lane(sigma, y) * Sigma * (b - kxbar)


def primal_update_plain(x, kty, c, T, lb, ub, tau, theta):
    """Plain PyTorch version of the primal update; returns (x_new, x̄)."""
    x_new = torch.clamp(x - per_lane(tau, x) * T * (c - kty), lb, ub)
    return x_new, x_new + per_lane(theta, x) * (x_new - x)


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"repro_torch kernels run on CUDA (or, as their "
                         f"plain version, on the CPU); got {t.device}")
    return False


def _check_vectors(shape, *vecs: torch.Tensor) -> None:
    for v in vecs:
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"expected a {tuple(shape)} vector, got "
                             f"{tuple(v.shape)}")


def lane_scalars(batch: int, *scalars: torch.Tensor):
    """Step sizes as the kernels read them: one value per lane.  A 0-d
    (or one-element) tensor serves every lane; otherwise the tensor must
    hold ``batch`` values."""
    out = []
    for s in scalars:
        if not torch.is_tensor(s):
            raise TypeError(f"kernel operands must be tensors, got "
                            f"{type(s).__name__} (keep step sizes on the "
                            f"device as 0-d tensors)")
        if s.numel() == 1 and batch > 1:
            s = s.reshape(1).expand(batch).contiguous()
        elif s.numel() != batch:
            raise ValueError(f"step sizes are 0-d tensors or hold one value "
                             f"per lane ({batch}), got shape "
                             f"{tuple(s.shape)}")
        out.append(s)
    return out


def batch_of(v: torch.Tensor) -> int:
    """Lanes of a (d,) or (B, d) vector."""
    if v.dim() not in (1, 2):
        raise ValueError(f"expected a (d,) or (B, d) vector, got "
                         f"{tuple(v.shape)}")
    return v.shape[0] if v.dim() == 2 else 1


def dual_update(y, kxbar, b, Sigma, sigma):
    """B1: ``y + sigma * Sigma * (b - kxbar)``; ``sigma`` a 0-d tensor,
    or (B,) against (B, m) vectors."""
    if _on_cpu(y):
        return dual_update_plain(y, kxbar, b, Sigma, sigma)
    B = batch_of(y)
    (sigma,) = lane_scalars(B, sigma)
    _build.check_cuda_operands(y, kxbar, b, Sigma, sigma)
    _check_vectors(y.shape, y, kxbar, b, Sigma)
    out = torch.empty_like(y)
    _build.launch("pdhg_dual_update", y.dtype, y.data_ptr(),
                  kxbar.data_ptr(), b.data_ptr(), Sigma.data_ptr(),
                  sigma.data_ptr(), out.data_ptr(), y.shape[-1], B)
    dual_update.launches += 1
    return out


def primal_update(x, kty, c, T, lb, ub, tau, theta):
    """B2: returns ``(x_new, x_bar)``; ``tau``/``theta`` 0-d tensors, or
    (B,) against (B, n) vectors, and the bounds may be ±inf."""
    if _on_cpu(x):
        return primal_update_plain(x, kty, c, T, lb, ub, tau, theta)
    B = batch_of(x)
    tau, theta = lane_scalars(B, tau, theta)
    _build.check_cuda_operands(x, kty, c, T, lb, ub, tau, theta)
    _check_vectors(x.shape, x, kty, c, T, lb, ub)
    x_new = torch.empty_like(x)
    x_bar = torch.empty_like(x)
    _build.launch("pdhg_primal_update", x.dtype, x.data_ptr(),
                  kty.data_ptr(), c.data_ptr(), T.data_ptr(), lb.data_ptr(),
                  ub.data_ptr(), tau.data_ptr(), theta.data_ptr(),
                  x_new.data_ptr(), x_bar.data_ptr(), x.shape[-1], B)
    primal_update.launches += 1
    return x_new, x_bar


dual_update.launches = 0
primal_update.launches = 0
