"""Check-window megakernel B3: ``n_steps`` fused PDHG steps per launch.

Port of ``repro/kernels/pdhg_megakernel.py::_dense_kernel``
(``fused_dense_steps``).  The engine's loop runs ``check_every`` steps
per residual check; in megakernel mode the whole window is ONE
cooperative CUDA launch (``fused_dense_kernel`` in
``csrc/pdhg_kernels.cu``, which also says what bounds it on the H100).
The residual / restart check stays outside, so fused and stepped loops
visit the same check points.

The kernel applies the same per-element algebra as the update kernels
(the shared ``dual_elem``/``primal_elem`` device functions), including
the ``strongly_convex`` θ-schedule: θ = 1/√(1+2γτ), τ ← θτ, σ ← σ/θ
after every step.  Noiseless only; the engine mounts it only when no
read noise is configured.

``fused_dense_steps`` launches the kernel for CUDA tensors and takes the
plain version (a port of the reference's ``_run_steps``) for CPU
tensors, and only for them; it counts its launches in ``.launches``.
"""
from __future__ import annotations

import torch

from . import _build
from .pdhg_update import _on_cpu, dual_update_plain, primal_update_plain


def fused_dense_steps_plain(K, K_adj, b, c, lb, ub, T, Sigma,
                            x, x_prev, x_bar, y, tau, sigma, *,
                            n_steps: int, gamma: float):
    """``n_steps`` of ``engine.pdhg_step`` with the ergodic sums, in
    plain PyTorch (the order of operations mirrors the engine's step)."""
    xs = torch.zeros_like(x)
    ys = torch.zeros_like(y)
    for _ in range(int(n_steps)):
        y_n = dual_update_plain(y, torch.mv(K, x_bar), b, Sigma, sigma)
        KTy = torch.mv(K_adj, y_n)
        theta_n = 1.0 / torch.sqrt(1.0 + 2.0 * gamma * tau)
        x_n, x_bar = primal_update_plain(x, KTy, c, T, lb, ub, tau, theta_n)
        x, x_prev, y = x_n, x, y_n
        tau, sigma = theta_n * tau, sigma / theta_n
        xs = xs + x_n
        ys = ys + y_n
    return x, x_prev, x_bar, y, tau, sigma, xs, ys


def fused_dense_steps(K, K_adj, b, c, lb, ub, T, Sigma,
                      x, x_prev, x_bar, y, tau, sigma, *,
                      n_steps: int, gamma: float):
    """B3: ``n_steps`` fused dense PDHG steps; K (m, n), K_adj (n, m),
    ``tau``/``sigma`` 0-d tensors.  Returns ``(x, x_prev, x_bar, y, tau,
    sigma, x_sum, y_sum)``; the caller's tensors are not modified."""
    if _on_cpu(K):
        return fused_dense_steps_plain(
            K, K_adj, b, c, lb, ub, T, Sigma, x, x_prev, x_bar, y, tau,
            sigma, n_steps=n_steps, gamma=gamma)
    m, n = K.shape
    _build.check_cuda_operands(K, K_adj, b, c, lb, ub, T, Sigma, x, x_prev,
                               x_bar, y, tau, sigma)
    if K_adj.shape != (n, m):
        raise ValueError(f"K_adj must be ({n}, {m}), got "
                         f"{tuple(K_adj.shape)}")
    for v, d in ((b, m), (y, m), (Sigma, m), (c, n), (lb, n), (ub, n),
                 (T, n), (x, n), (x_prev, n), (x_bar, n)):
        if v.shape != (d,):
            raise ValueError(f"expected a ({d},) vector, got "
                             f"{tuple(v.shape)}")
    if tau.numel() != 1 or sigma.numel() != 1:
        raise ValueError("tau and sigma are 0-d tensors")
    # the kernel updates the state in place: give it copies
    x, x_prev, x_bar, y = x.clone(), x_prev.clone(), x_bar.clone(), y.clone()
    xs = torch.zeros_like(x)
    ys = torch.zeros_like(y)
    tau_out = torch.empty((), dtype=K.dtype, device=K.device)
    sigma_out = torch.empty((), dtype=K.dtype, device=K.device)
    _build.launch(
        "pdhg_fused_dense", K.dtype, K.data_ptr(), K_adj.data_ptr(),
        b.data_ptr(), c.data_ptr(), lb.data_ptr(), ub.data_ptr(),
        T.data_ptr(), Sigma.data_ptr(), x.data_ptr(), x_prev.data_ptr(),
        x_bar.data_ptr(), y.data_ptr(), tau.data_ptr(), sigma.data_ptr(),
        tau_out.data_ptr(), sigma_out.data_ptr(), xs.data_ptr(),
        ys.data_ptr(), m, n, int(n_steps), float(gamma))
    fused_dense_steps.launches += 1
    return x, x_prev, x_bar, y, tau_out, sigma_out, xs, ys


fused_dense_steps.launches = 0
