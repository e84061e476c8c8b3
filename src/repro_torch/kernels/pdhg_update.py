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

The stepped window (``core.engine``) runs each kernel's step form
instead, which writes into caller buffers and folds the window's ergodic
sum into the same pass, beside ``schedule``, one launch a window that
writes every step's τ, σ and θ up front (``dual_step_kernel``,
``primal_step_kernel`` and ``schedule_kernel``, same file).  With them a
step is four launches that need nothing from the host (the two products,
``dual_step``, ``primal_step``), so the window can run as one CUDA graph:

    schedule:     sched[0|1|2, s] = τ_s, σ_s, θ_s for s < n_steps, and
                  the τ, σ after the window (the loop's θ-schedule)
    dual_step:    out = y + σ_s·Σ⊙(b − Kx̄);  ys += out
    primal_step:  x_new, x̄ = the primal update at τ_s, θ_s;  xs += x_new

Every wrapper launches its kernel for CUDA tensors and takes its plain
version for CPU tensors, and only for them; each counts its kernel
launches in ``.launches``.

All take an optional leading batch axis: vectors ``(B, d)`` with step
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


# ------------------------------------------------------ the step forms ---

def schedule_buffers(tau: torch.Tensor, n_steps: int):
    """Empty ``(sched, tau_out, sigma_out)`` for ``schedule`` on step sizes
    shaped like ``tau``: ``sched`` is (3, n_steps, *tau.shape)."""
    return (tau.new_empty((3, n_steps, *tau.shape)), torch.empty_like(tau),
            torch.empty_like(tau))


def schedule_plain(tau, sigma, n_steps: int, gamma: float, out=None):
    """Plain PyTorch version of the window's schedule: the loop's
    θ-schedule, one step after the other; returns ``(sched, tau_out,
    sigma_out)`` (into ``out`` when given)."""
    sched, tau_out, sigma_out = (schedule_buffers(tau, n_steps)
                                 if out is None else out)
    for s in range(n_steps):
        theta = 1.0 / torch.sqrt(1.0 + 2.0 * gamma * tau)
        sched[0, s].copy_(tau)
        sched[1, s].copy_(sigma)
        sched[2, s].copy_(theta)
        tau = theta * tau
        sigma = sigma / theta
    tau_out.copy_(tau)
    sigma_out.copy_(sigma)
    return sched, tau_out, sigma_out


def dual_step_plain(y, kxbar, b, Sigma, sigma, ys, out=None):
    """Plain PyTorch version of B1's step form: the dual update (into
    ``out`` when given), added into ``ys``."""
    out = torch.add(y, per_lane(sigma, y) * Sigma * (b - kxbar), out=out)
    ys.add_(out)
    return out


def primal_step_plain(x, kty, c, T, lb, ub, tau, theta, xs, x_new=None,
                      x_bar=None):
    """Plain PyTorch version of B2's step form: ``(x_new, x̄)`` (into the
    buffers when given), ``x_new`` added into ``xs``."""
    x_new = torch.clamp(x - per_lane(tau, x) * T * (c - kty), lb, ub,
                        out=x_new)
    x_bar = torch.add(x_new, per_lane(theta, x) * (x_new - x), out=x_bar)
    xs.add_(x_new)
    return x_new, x_bar


def _distinct(outs, ins) -> None:
    """The kernels' outputs share no memory with each other or with
    their inputs (their pointers are ``__restrict__``)."""
    out_ptrs = [t.data_ptr() for t in outs if t.numel()]
    in_ptrs = {t.data_ptr() for t in ins if t.numel()}
    if len(set(out_ptrs)) < len(out_ptrs) or in_ptrs.intersection(out_ptrs):
        raise ValueError("step-form outputs must not alias their inputs "
                         "or each other")


def schedule(tau, sigma, n_steps: int, gamma: float, out=None):
    """The window's step-size schedule in one launch: ``(sched, tau_out,
    sigma_out)``, with step ``s``'s τ, σ and θ of every lane at
    ``sched[0, s]``, ``sched[1, s]`` and ``sched[2, s]``; ``tau``/``sigma``
    0-d, or (B,) for a batch."""
    if _on_cpu(tau):
        return schedule_plain(tau, sigma, n_steps, gamma, out)
    sched, tau_out, sigma_out = (schedule_buffers(tau, n_steps)
                                 if out is None else out)
    _build.check_cuda_operands(tau, sigma, sched, tau_out, sigma_out)
    B = max(1, tau.numel())
    for t in (sigma, tau_out, sigma_out):
        _check_vectors(tau.shape, t)
    _check_vectors((3, n_steps, *tau.shape), sched)
    _build.launch("pdhg_schedule", tau.dtype, tau.data_ptr(),
                  sigma.data_ptr(), sched.data_ptr(), tau_out.data_ptr(),
                  sigma_out.data_ptr(), B, int(n_steps), float(gamma))
    schedule.launches += 1
    return sched, tau_out, sigma_out


def dual_step(y, kxbar, b, Sigma, sigma, ys, out=None):
    """B1's step form: ``out = y + sigma * Sigma * (b - kxbar)`` and
    ``ys += out``; ``sigma`` a 0-d tensor, or (B,) against (B, m)
    vectors (a slot of ``schedule``'s output)."""
    if _on_cpu(y):
        return dual_step_plain(y, kxbar, b, Sigma, sigma, ys, out)
    B = batch_of(y)
    (sigma,) = lane_scalars(B, sigma)
    out = torch.empty_like(y) if out is None else out
    _build.check_cuda_operands(y, kxbar, b, Sigma, sigma, out, ys)
    _check_vectors(y.shape, y, kxbar, b, Sigma, out, ys)
    _distinct((out, ys), (y, kxbar, b, Sigma, sigma))
    _build.launch("pdhg_dual_step", y.dtype, y.data_ptr(),
                  kxbar.data_ptr(), b.data_ptr(), Sigma.data_ptr(),
                  sigma.data_ptr(), out.data_ptr(), ys.data_ptr(),
                  y.shape[-1], B)
    dual_step.launches += 1
    return out


def primal_step(x, kty, c, T, lb, ub, tau, theta, xs, x_new=None,
                x_bar=None):
    """B2's step form: ``(x_new, x_bar)`` and ``xs += x_new``;
    ``tau``/``theta`` 0-d tensors, or (B,) against (B, n) vectors."""
    if _on_cpu(x):
        return primal_step_plain(x, kty, c, T, lb, ub, tau, theta, xs,
                                 x_new, x_bar)
    B = batch_of(x)
    tau, theta = lane_scalars(B, tau, theta)
    x_new = torch.empty_like(x) if x_new is None else x_new
    x_bar = torch.empty_like(x) if x_bar is None else x_bar
    _build.check_cuda_operands(x, kty, c, T, lb, ub, tau, theta, x_new,
                               x_bar, xs)
    _check_vectors(x.shape, x, kty, c, T, lb, ub, x_new, x_bar, xs)
    _distinct((x_new, x_bar, xs), (x, kty, c, T, lb, ub, tau, theta))
    _build.launch("pdhg_primal_step", x.dtype, x.data_ptr(),
                  kty.data_ptr(), c.data_ptr(), T.data_ptr(), lb.data_ptr(),
                  ub.data_ptr(), tau.data_ptr(), theta.data_ptr(),
                  x_new.data_ptr(), x_bar.data_ptr(), xs.data_ptr(),
                  x.shape[-1], B)
    primal_step.launches += 1
    return x_new, x_bar


schedule.launches = 0
dual_step.launches = 0
primal_step.launches = 0
