"""Check-window megakernels: ``n_steps`` fused PDHG steps per launch.

    B3  fused_dense_steps     port of repro/kernels/pdhg_megakernel.py
                              ::_dense_kernel, two forms:
          (K, K_adj)          the two-matrix form, for a distinct K_adj
          (K, None)           the transpose form, fused_dense_steps_kt,
                              for an adjoint that is exactly K^T; it
                              reads K once a step for both products
    B5  fused_ell_steps       port of ::_ell_kernel in the same file

The engine's loop runs ``check_every`` steps per residual check; in
megakernel mode the whole window is ONE cooperative CUDA launch
(``fused_dense_kernel``, ``fused_dense_t_kernel`` and
``fused_ell_kernel`` in ``csrc/pdhg_kernels.cu``, which also says what
bounds each on the H100).  The residual / restart check stays outside,
so fused and stepped loops visit the same check points.

The kernels apply the same per-element algebra as the update kernels
(the shared ``dual_elem``/``primal_elem`` device functions of
``csrc/pdhg_common.cuh``), and B5 the same ELL row product as B4,
including the ``strongly_convex`` θ-schedule per lane: θ = 1/√(1+2γτ),
τ ← θτ, σ ← σ/θ after every step.  Noiseless only; the engine mounts
them only when no read noise is configured.

All take an optional leading batch axis: operators ``(B, ...)``,
vectors ``(B, d)`` and ``tau``/``sigma`` of shape ``(B,)``; one launch
runs every lane, and an ``active`` (B,) bool mask: only the live lanes
are stepped, and a stopped lane's state, step sizes and (zero) sums come
back as they went in.  B5 also takes each ELL form's row lengths
(``sparse_mvm.ell_row_len``).  The wrappers launch the kernel for CUDA
tensors and take the plain version (a port of the reference's
``_run_steps``) for CPU tensors, and only for them; each form counts its
launches in ``.launches`` (``fused_dense_steps.launches`` the
two-matrix form, ``fused_dense_steps_kt.launches`` the transpose form).
"""
from __future__ import annotations

import torch

from . import _build
from .pdhg_update import (
    _on_cpu,
    batch_of,
    dual_update_plain,
    lane_scalars,
    primal_update_plain,
)
from .sparse_mvm import check_ell, ell_matvec_plain


def _run_steps_plain(fwd, adj, b, c, lb, ub, T, Sigma, x, x_prev, x_bar, y,
                     tau, sigma, n_steps: int, gamma: float):
    """``n_steps`` of ``engine.pdhg_step`` with the ergodic sums, in plain
    PyTorch over the products ``fwd``/``adj`` (the order of operations
    mirrors the engine's step)."""
    xs = torch.zeros_like(x)
    ys = torch.zeros_like(y)
    for _ in range(int(n_steps)):
        y_n = dual_update_plain(y, fwd(x_bar), b, Sigma, sigma)
        KTy = adj(y_n)
        theta_n = 1.0 / torch.sqrt(1.0 + 2.0 * gamma * tau)
        x_n, x_bar = primal_update_plain(x, KTy, c, T, lb, ub, tau, theta_n)
        x, x_prev, y = x_n, x, y_n
        tau, sigma = theta_n * tau, sigma / theta_n
        xs = xs + x_n
        ys = ys + y_n
    return x, x_prev, x_bar, y, tau, sigma, xs, ys


def _dense_mv(M):
    if M.dim() == 2:
        return lambda v: torch.mv(M, v)
    return lambda v: torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


def _keep_stopped(out, active, x, x_prev, x_bar, y, tau, sigma):
    """A plain window's outputs with the lanes that ``active`` marks
    stopped (None: none) taking back their inputs, with zero sums."""
    if active is None:
        return out
    tau, sigma = (torch.as_tensor(s, dtype=x.dtype, device=x.device)
                  .expand(active.shape) for s in (tau, sigma))
    old = (x, x_prev, x_bar, y, tau, sigma, torch.zeros_like(x),
           torch.zeros_like(y))
    return tuple(torch.where(active.unsqueeze(-1) if a.dim() > active.dim()
                             else active, a, o) for a, o in zip(out, old))


def fused_dense_steps_plain(K, K_adj, b, c, lb, ub, T, Sigma,
                            x, x_prev, x_bar, y, tau, sigma, *,
                            n_steps: int, gamma: float, active=None):
    """B3's plain version: ``n_steps`` dense steps, K (m, n) or (B, m, n);
    ``K_adj=None`` is K's transpose; lanes that ``active`` marks stopped
    come back unchanged, with zero sums."""
    adj = K.mT if K_adj is None else K_adj
    out = _run_steps_plain(_dense_mv(K), _dense_mv(adj), b, c, lb, ub, T,
                           Sigma, x, x_prev, x_bar, y, tau, sigma, n_steps,
                           gamma)
    return _keep_stopped(out, active, x, x_prev, x_bar, y, tau, sigma)


def fused_ell_steps_plain(data_f, cols_f, data_a, cols_a, b, c, lb, ub, T,
                          Sigma, x, x_prev, x_bar, y, tau, sigma, *,
                          n_steps: int, gamma: float, row_len_f=None,
                          row_len_a=None, active=None):
    """B5's plain version: ``n_steps`` ELL steps on the forward ELL of K
    (m, Wf) and the stored ELL of K^T (n, Wa), optionally batched, with
    optional row lengths; lanes that ``active`` marks stopped come back
    unchanged, with zero sums."""
    out = _run_steps_plain(
        lambda v: ell_matvec_plain(data_f, cols_f, v, row_len_f),
        lambda v: ell_matvec_plain(data_a, cols_a, v, row_len_a),
        b, c, lb, ub, T, Sigma, x, x_prev, x_bar, y, tau, sigma, n_steps,
        gamma)
    return _keep_stopped(out, active, x, x_prev, x_bar, y, tau, sigma)


def _live_mask(active, B: int, device):
    """``active`` as the kernels read it: a contiguous (B,) bool mask on
    ``device`` (None stays None: every lane)."""
    if active is None:
        return None
    active = active.reshape(-1).contiguous()
    if (active.dtype != torch.bool or active.numel() != B
            or active.device != device):
        raise ValueError(f"active must be a ({B},) bool mask on {device}, "
                         f"got {active.dtype} {tuple(active.shape)} on "
                         f"{active.device}")
    return active


def _lane_list(B: int, device):
    """The live-lane list a kernel's prologue writes, and its length."""
    return torch.empty(B + 1, dtype=torch.int32, device=device)


def _state_for_kernel(m, n, B, b, c, lb, ub, T, Sigma, x, x_prev, x_bar, y,
                      tau, sigma, ref, n_steps):
    """Checks the vectors and returns what the kernel writes: copies of
    the state (it updates them in place), zeroed sums, per-lane step
    sizes in and out and the schedule scratch."""
    lead = (B,) if ref.dim() == 3 else ()
    tau, sigma = lane_scalars(B, tau, sigma)
    _build.check_cuda_operands(ref, b, c, lb, ub, T, Sigma, x, x_prev,
                               x_bar, y, tau, sigma)
    for v, d in ((b, m), (y, m), (Sigma, m), (c, n), (lb, n), (ub, n),
                 (T, n), (x, n), (x_prev, n), (x_bar, n)):
        if tuple(v.shape) != (*lead, d):
            raise ValueError(f"expected a {(*lead, d)} vector, got "
                             f"{tuple(v.shape)}")
    opts = dict(dtype=ref.dtype, device=ref.device)
    return dict(
        x=x.clone(), x_prev=x_prev.clone(), x_bar=x_bar.clone(),
        y=y.clone(), xs=torch.zeros_like(x), ys=torch.zeros_like(y),
        tau_in=tau, sigma_in=sigma,
        tau_out=torch.empty(lead, **opts), sigma_out=torch.empty(lead, **opts),
        sched=torch.empty((3, max(int(n_steps), 1), B), **opts))


def _outputs(s):
    return (s["x"], s["x_prev"], s["x_bar"], s["y"], s["tau_out"],
            s["sigma_out"], s["xs"], s["ys"])


def _dense_shape(K):
    if K.dim() not in (2, 3):
        raise ValueError(f"K must be (m, n) or (B, m, n), got "
                         f"{tuple(K.shape)}")
    m, n = K.shape[-2:]
    return m, n, (K.shape[0] if K.dim() == 3 else 1)


def fused_dense_steps(K, K_adj, b, c, lb, ub, T, Sigma,
                      x, x_prev, x_bar, y, tau, sigma, *,
                      n_steps: int, gamma: float, active=None):
    """B3: ``n_steps`` fused dense PDHG steps; K (m, n) and K_adj (n, m),
    or (B, m, n) and (B, n, m) with (B, d) vectors and (B,) step sizes.
    ``K_adj=None`` says the adjoint is exactly K^T and runs the transpose
    form (``fused_dense_steps_kt``), which reads K once a step; a tensor
    runs the two-matrix form.  ``active`` ((B,) bool on the card, or 0-d
    for one instance; None: every lane) names the lanes to step.
    Returns ``(x, x_prev, x_bar, y, tau, sigma, x_sum, y_sum)``; the
    caller's tensors are not modified."""
    if K_adj is None:
        return fused_dense_steps_kt(
            K, b, c, lb, ub, T, Sigma, x, x_prev, x_bar, y, tau, sigma,
            n_steps=n_steps, gamma=gamma, active=active)
    if _on_cpu(K):
        return fused_dense_steps_plain(
            K, K_adj, b, c, lb, ub, T, Sigma, x, x_prev, x_bar, y, tau,
            sigma, n_steps=n_steps, gamma=gamma, active=active)
    m, n, B = _dense_shape(K)
    if tuple(K_adj.shape) != (*K.shape[:-2], n, m):
        raise ValueError(f"K_adj must be {(*K.shape[:-2], n, m)}, got "
                         f"{tuple(K_adj.shape)}")
    _build.check_cuda_operands(K, K_adj)
    active = _live_mask(active, B, K.device)
    s = _state_for_kernel(m, n, B, b, c, lb, ub, T, Sigma, x, x_prev, x_bar,
                          y, tau, sigma, K, n_steps)
    lanes = None if active is None else _lane_list(B, K.device)
    p = {k: v.data_ptr() for k, v in s.items()}
    _build.launch(
        "pdhg_fused_dense", K.dtype, K.data_ptr(), K_adj.data_ptr(),
        b.data_ptr(), c.data_ptr(), lb.data_ptr(), ub.data_ptr(),
        T.data_ptr(), Sigma.data_ptr(), p["x"], p["x_prev"], p["x_bar"],
        p["y"], p["tau_in"], p["sigma_in"], p["tau_out"], p["sigma_out"],
        p["xs"], p["ys"], p["sched"], _build.pointer(active),
        _build.pointer(lanes), m, n, B, int(n_steps), float(gamma))
    fused_dense_steps.launches += 1
    return _outputs(s)


def fused_dense_steps_kt(K, b, c, lb, ub, T, Sigma, x, x_prev, x_bar, y,
                         tau, sigma, *, n_steps: int, gamma: float,
                         active=None):
    """B3's transpose form: ``fused_dense_steps(K, None, ...)``, the
    adjoint being exactly K^T, which is never formed.  One row panel a
    block; each step reads K once (``fused_dense_t_kernel``)."""
    if _on_cpu(K):
        return fused_dense_steps_plain(
            K, None, b, c, lb, ub, T, Sigma, x, x_prev, x_bar, y, tau,
            sigma, n_steps=n_steps, gamma=gamma, active=active)
    m, n, B = _dense_shape(K)
    if m == 0 or n == 0:
        raise ValueError(f"K must not be empty, got {tuple(K.shape)}")
    _build.check_cuda_operands(K)
    active = _live_mask(active, B, K.device)
    s = _state_for_kernel(m, n, B, b, c, lb, ub, T, Sigma, x, x_prev, x_bar,
                          y, tau, sigma, K, n_steps)
    # a partial K^T y of n values for each unit of rows: at most one a
    # block (one block an SM) or one a lane
    sms = torch.cuda.get_device_properties(K.device).multi_processor_count
    slots = max(B, sms)
    part = torch.empty((slots, n), dtype=K.dtype, device=K.device)
    lanes = _lane_list(B, K.device)
    p = {k: v.data_ptr() for k, v in s.items()}
    _build.launch(
        "pdhg_fused_dense_t", K.dtype, K.data_ptr(), b.data_ptr(),
        c.data_ptr(), lb.data_ptr(), ub.data_ptr(), T.data_ptr(),
        Sigma.data_ptr(), p["x"], p["x_prev"], p["x_bar"], p["y"],
        p["tau_in"], p["sigma_in"], p["tau_out"], p["sigma_out"], p["xs"],
        p["ys"], p["sched"], part.data_ptr(), _build.pointer(active),
        lanes.data_ptr(), slots, m, n, B, int(n_steps), float(gamma))
    fused_dense_steps_kt.launches += 1
    return _outputs(s)


def fused_ell_steps(data_f, cols_f, data_a, cols_a, b, c, lb, ub, T, Sigma,
                    x, x_prev, x_bar, y, tau, sigma, *,
                    n_steps: int, gamma: float, row_len_f=None,
                    row_len_a=None, active=None):
    """B5: ``n_steps`` fused ELL PDHG steps; the forward ELL of K
    (m, Wf) and the stored ELL of K^T (n, Wa), int32 columns, or the
    same with a leading batch axis and (B,) step sizes.  ``row_len_f``/
    ``row_len_a`` (``sparse_mvm.ell_row_len`` of each form; None: every
    slot) end each row at its last stored slot; ``active`` ((B,) bool on
    the card, or 0-d for one instance; None: every lane) names the lanes
    to step, and only their rows are read.  Same returns as
    ``fused_dense_steps``; the caller's tensors are not modified."""
    if _on_cpu(data_f):
        return fused_ell_steps_plain(
            data_f, cols_f, data_a, cols_a, b, c, lb, ub, T, Sigma, x,
            x_prev, x_bar, y, tau, sigma, n_steps=n_steps, gamma=gamma,
            row_len_f=row_len_f, row_len_a=row_len_a, active=active)
    B = batch_of(x)
    m, wf = check_ell(data_f, cols_f, row_len_f)
    n, wa = check_ell(data_a, cols_a, row_len_a)
    active = _live_mask(active, B, data_f.device)
    lead = tuple(data_f.shape[:-2])
    if tuple(data_a.shape[:-2]) != lead or (lead and lead[0] != B):
        raise ValueError(f"the two ELL forms and the vectors must share "
                         f"one batch, got {tuple(data_f.shape)}, "
                         f"{tuple(data_a.shape)} and {tuple(x.shape)}")
    s = _state_for_kernel(m, n, B, b, c, lb, ub, T, Sigma, x, x_prev, x_bar,
                          y, tau, sigma, data_f, n_steps)
    _build.check_cuda_operands(data_f, data_a, b)
    lanes = _lane_list(B, data_f.device)
    p = {k: v.data_ptr() for k, v in s.items()}
    _build.launch(
        "pdhg_fused_ell", data_f.dtype, data_f.data_ptr(),
        cols_f.data_ptr(), _build.pointer(row_len_f), data_a.data_ptr(),
        cols_a.data_ptr(), _build.pointer(row_len_a), b.data_ptr(),
        c.data_ptr(), lb.data_ptr(), ub.data_ptr(), T.data_ptr(),
        Sigma.data_ptr(), p["x"], p["x_prev"], p["x_bar"], p["y"],
        p["tau_in"], p["sigma_in"], p["tau_out"], p["sigma_out"], p["xs"],
        p["ys"], p["sched"], _build.pointer(active), lanes.data_ptr(), m, n,
        wf, wa, B, int(n_steps), float(gamma))
    fused_ell_steps.launches += 1
    return _outputs(s)


fused_dense_steps.launches = 0
fused_dense_steps_kt.launches = 0
fused_ell_steps.launches = 0

__all__ = ["fused_dense_steps", "fused_dense_steps_kt",
           "fused_dense_steps_plain", "fused_ell_steps",
           "fused_ell_steps_plain"]
