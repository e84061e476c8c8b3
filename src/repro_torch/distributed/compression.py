"""Quantized collectives -- bandwidth compression for the critical path;
the port of ``repro.distributed.compression``.

  compressed_psum: two phases -- (1) all-reduce the ranks' max |x| (one
  number, a max reduction), (2) quantize locally against that GLOBAL
  scale, sum the integers in int32 (exact, so associative), dequantize.
  Symmetric stochastic rounding keeps the sum unbiased, which keeps the
  solver's Assumption-2 guarantees.

The digital analogue of the paper's low-precision analog aggregation:
current summation on crossbar columns is intrinsically "compressed" by
ADC resolution; here the ADC is the integer cast.  Stochastic rounding
draws from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.engine import all_reduce


def _stochastic_round(x, generator: torch.Generator):
    floor = torch.floor(x)
    frac = x - floor
    u = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                   device=x.device)
    return floor + (u < frac).to(x.dtype)


def compressed_psum(x, axis_names, generator: Optional[torch.Generator] = None,
                    bits: int = 8):
    """Unbiased quantized sum of ``x`` over the ranks of ``axis_names``,
    the process group of the axes to reduce over (``Mesh.group(axes)``;
    None for a one-rank axis without a process group).  With
    ``generator`` the rounding is stochastic, else to nearest."""
    qmax = 2.0 ** (bits - 1) - 1.0
    # the global scale: one exact max reduction of one number
    amax = all_reduce(torch.max(torch.abs(x)).reshape(1), axis_names,
                      op="max")[0]
    scale = torch.clamp(amax, min=1e-30) / qmax
    q = x / scale
    if generator is not None:
        q = _stochastic_round(q, generator)
    else:
        q = torch.round(q)
    q = torch.clamp(q, -qmax, qmax).to(torch.int32)
    s = all_reduce(q, axis_names)
    return s.to(x.dtype) * scale


def quantize_int8(x):
    """Standalone (de)quantization pair for gradient compression tests."""
    qmax = 127.0
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-30) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale
