"""Carry data across the two packages and onto a device.

* ``from_reference_lp`` reads any LP-like object (the JAX package's
  ``StandardLP`` included) by duck typing and returns the port's
  ``StandardLP``; only numpy arrays cross, so nothing here imports the
  other package.
* ``lp_tensors`` moves an LP onto a device in one dtype.
* ``Draws`` holds the random vectors a solve would otherwise draw
  itself.  Torch cannot reproduce JAX's threefry streams, so a parity
  test draws them with the reference and injects them here.
* ``device_from_reference`` and ``from_reference_encoded`` read a
  crossbar ``DeviceModel`` and a programmed ``EncodedMatrix`` of the
  reference by their fields, so a test can hand the reference's
  conductances to the port.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ._device import resolve_device
from .lp.problem import SparseCOO, StandardLP


def _as_numpy(a):
    return None if a is None else np.asarray(a)


def from_reference_lp(obj) -> StandardLP:
    """Port-side ``StandardLP`` from anything with ``c, K, b, lb, ub``
    (``K`` dense, or a COO triplet with ``data/row/col/shape``) and
    optional ``name, obj_opt, x_opt``."""
    K = obj.K
    if all(hasattr(K, a) for a in ("data", "row", "col", "shape")):
        K = SparseCOO(np.asarray(K.data), np.asarray(K.row),
                      np.asarray(K.col), tuple(K.shape))
    else:
        K = np.asarray(K)
    obj_opt = getattr(obj, "obj_opt", None)
    return StandardLP(
        c=np.asarray(obj.c), K=K, b=np.asarray(obj.b),
        lb=np.asarray(obj.lb), ub=np.asarray(obj.ub),
        name=getattr(obj, "name", "lp"),
        x_opt=_as_numpy(getattr(obj, "x_opt", None)),
        obj_opt=None if obj_opt is None else float(obj_opt),
    )


class LPTensors(NamedTuple):
    """An LP's data on one device, in one dtype (K always dense)."""

    K: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor


def lp_tensors(lp: StandardLP, device, dtype=torch.float64) -> LPTensors:
    """Move ``lp`` to ``device`` as ``dtype`` (a sparse K is densified:
    the single-instance path is dense)."""
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return LPTensors(t(lp.K_dense), t(lp.b), t(lp.c), t(lp.lb), t(lp.ub))


class Draws(NamedTuple):
    """Injected random vectors for one solve (``solve_jit``, the host
    driver ``solve``, ``solve_crossbar_jit`` and its refinement) or one
    lane of a batch (``runtime.batch``).

    ``x0`` (n,) and ``y0`` (m,) are the PDHG start (``x0`` is clipped to
    the scaled bounds, which leaves a reference ``draw_init`` output
    unchanged); ``v0`` (m+n,) is the norm estimate's start vector before
    normalisation, or ``None`` for the estimator's seeded default;
    ``program`` is the crossbar stream's programming draw ``(z_pos,
    z_neg)`` (see ``crossbar.encode.encode_core``), or ``None``."""

    x0: object
    y0: object
    v0: Optional[object] = None
    program: Optional[object] = None


def place_draws(draws: Optional[Draws], lb: torch.Tensor, ub: torch.Tensor):
    """``(x0, y0, v0)`` in ``lb``'s dtype on its device, ``x0`` clipped
    to ``[lb, ub]``; ``None`` for what was not injected."""
    if draws is None:
        return None, None, None

    def t(a):
        return (None if a is None else
                torch.as_tensor(np.array(a), dtype=lb.dtype, device=lb.device))

    return torch.clamp(t(draws.x0), lb, ub), t(draws.y0), t(draws.v0)


def device_from_reference(dev):
    """The port's crossbar ``DeviceModel`` with the fields of ``dev``."""
    import dataclasses

    from .crossbar.device import DeviceModel

    return DeviceModel(**{f.name: getattr(dev, f.name)
                          for f in dataclasses.fields(DeviceModel)})


def from_reference_encoded(enc, device=None, dtype=torch.float64):
    """The port's ``EncodedMatrix`` from the reference's: ``g_pos``,
    ``g_neg``, ``scale``, ``rows``, ``cols`` and ``fill`` read as numpy,
    the conductances placed on ``device`` (default: the card) in
    ``dtype``."""
    from .crossbar.encode import EncodedMatrix

    device = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return EncodedMatrix(
        g_pos=t(enc.g_pos), g_neg=t(enc.g_neg), scale=float(enc.scale),
        rows=int(enc.rows), cols=int(enc.cols),
        device=device_from_reference(enc.device), fill=float(enc.fill))
