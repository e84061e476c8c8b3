"""Differential-pair crossbar MVM: CUDA kernel B6 and its plain version.

    w = scale * (1 + noise) ⊙ ((G+ − G−) @ v)

The contract of ``repro/kernels/ops.py::crossbar_mvm`` (the wrapper
around ``repro/kernels/crossbar_mvm.py::_mvm_kernel``): G± are (R, C)
normalized conductances of any shape, ``v`` (C,), ``noise`` (R,) the
per-row multiplicative read-noise sample, ``scale`` the conductance
scale; the gain ``scale * (1 + noise)`` is applied once.  The kernel
(``crossbar_mvm_kernel`` in ``csrc/crossbar_mvm.cu``, which also says
what bounds it on the H100) masks ragged shapes itself, so nothing is
padded per call.

Every operand may carry a leading batch axis: G± (B, R, C), ``v``
(B, C), ``noise`` (B, R), ``scale`` a number or a (B,) tensor; the
kernel runs the batch in one launch.

``crossbar_mvm`` launches the kernel for CUDA tensors and takes the
plain version for CPU tensors, and only for them; it counts its kernel
launches in ``.launches``.
"""
from __future__ import annotations

import torch

from . import _build
from .pdhg_update import _on_cpu


def _gain(scale, noise):
    if torch.is_tensor(scale) and scale.dim() > 0:
        scale = scale[..., None]          # (B,) -> (B, 1) against (B, R)
    return scale * (1.0 + noise)


def crossbar_mvm_plain(g_pos, g_neg, v, scale, noise):
    """Plain PyTorch version of B6 (the kernel's oracle)."""
    w = torch.matmul(g_pos - g_neg, v.unsqueeze(-1)).squeeze(-1)
    return _gain(scale, noise) * w


def crossbar_mvm(g_pos, g_neg, v, scale, noise):
    """B6: ``scale * (1 + noise) * ((g_pos - g_neg) @ v)``, optionally
    batched over a leading axis."""
    if _on_cpu(g_pos):
        return crossbar_mvm_plain(g_pos, g_neg, v, scale, noise)
    batched = g_pos.dim() == 3
    if g_pos.dim() not in (2, 3) or g_neg.shape != g_pos.shape:
        raise ValueError(f"G+ and G- must be one (R, C) or (B, R, C) shape, "
                         f"got {tuple(g_pos.shape)} and "
                         f"{tuple(g_neg.shape)}")
    B = g_pos.shape[0] if batched else 1
    R, C = g_pos.shape[-2:]
    lead = (B,) if batched else ()
    if v.shape != (*lead, C):
        raise ValueError(f"v must be {(*lead, C)}, got {tuple(v.shape)}")
    if noise.shape != (*lead, R):
        raise ValueError(f"noise must be {(*lead, R)}, got "
                         f"{tuple(noise.shape)}")
    gain = _gain(scale, noise).contiguous()
    _build.check_cuda_operands(g_pos, g_neg, v, gain)
    out = torch.empty((*lead, R), dtype=g_pos.dtype, device=g_pos.device)
    _build.launch("crossbar_mvm", g_pos.dtype, g_pos.data_ptr(),
                  g_neg.data_ptr(), v.data_ptr(), gain.data_ptr(),
                  out.data_ptr(), R, C, B, R * C, C, R)
    crossbar_mvm.launches += 1
    return out


crossbar_mvm.launches = 0
