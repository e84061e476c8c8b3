"""Carry data across the two packages and onto a device.

* ``from_reference_lp`` reads any LP-like object (the JAX package's
  ``StandardLP`` included) by duck typing and returns the port's
  ``StandardLP``; only numpy arrays cross, so nothing here imports the
  other package.
* ``lp_tensors`` moves an LP onto a device in one dtype.
* ``Draws`` holds the random vectors a solve would otherwise draw
  itself.  Torch cannot reproduce JAX's threefry streams, so a parity
  test draws them with the reference and injects them here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

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
    """Injected random vectors for one solve.

    ``x0`` (n,) and ``y0`` (m,) are the PDHG start (``x0`` is clipped to
    the scaled bounds, which leaves a reference ``draw_init`` output
    unchanged); ``v0`` (m+n,) is the norm estimate's start vector before
    normalisation, or ``None`` for the estimator's seeded default."""

    x0: object
    y0: object
    v0: Optional[object] = None
