"""Mesh/sharding vocabulary of the distributed path; the port of
``repro.distributed.sharding``.

The rank grid IS the crossbar grid: row-blocks of K live on the "data"
axis (and "pod", when present), column-blocks on "model".  A ``K x``
product is a local tile product and an all-reduce over the column axis
-- the digital twin of the paper's "sum the output currents along a
crossbar grid row".

A placement spec is a tuple with one entry per leading dimension of an
array: None (every rank holds the whole dimension), an axis name, or a
tuple of axis names flattened in mesh order (the reference's
``PartitionSpec``).  ``local_block`` cuts this rank's block.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch


class Placement(NamedTuple):
    """An array's placement on a mesh: the port's ``NamedSharding``."""

    mesh: object
    spec: tuple


def named_sharding(mesh, *spec) -> Placement:
    return Placement(mesh, tuple(spec))


def row_axes(mesh) -> Tuple[str, ...]:
    """Axes carrying row-blocks of K ("pod" folds into rows when present)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def col_axes(mesh) -> Tuple[str, ...]:
    return ("model",)


def axis_size(mesh, axes: Sequence[str]) -> int:
    return int(np.prod([mesh.shape[a] for a in axes]))


def pad_to_multiple(x, mult: int, axis: int = 0, value: float = 0.0):
    """``x`` (a tensor or a numpy array) padded with ``value`` at the end
    of ``axis`` to a multiple of ``mult``."""
    size = x.shape[axis]
    target = math.ceil(size / mult) * mult
    if target == size:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - size)
    if not torch.is_tensor(x):
        return np.pad(x, pad, constant_values=value)
    shape = list(x.shape)
    shape[axis] = target - size
    return torch.cat([x, x.new_full(shape, value)], dim=axis)


def padded_dim(size: int, parts: int) -> int:
    return math.ceil(size / parts) * parts


def local_block(x, mesh, spec: Sequence):
    """This rank's block of the whole array ``x`` placed by ``spec``
    (see the module's docstring); each sharded dimension must divide
    evenly."""
    index = [slice(None)] * x.ndim
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        parts = mesh.size(axes)
        size = x.shape[dim]
        if size % parts:
            raise ValueError(f"dimension {dim} of size {size} does not "
                             f"split into {parts} blocks over {axes}")
        step = size // parts
        start = mesh.index(axes) * step
        index[dim] = slice(start, start + step)
    return x[tuple(index)]


def gather_blocks(block, mesh, axes):
    """The whole array from each rank's ``block`` of dimension 0 sharded
    over ``axes``, on every rank.  Built from an all-reduce, which every
    backend offers on CUDA tensors (gloo has no CUDA all-gather): each
    rank writes its block into a zero buffer and the sum over the
    ``axes`` group adds only zeros to each entry, which is exact."""
    from ..core.engine import all_reduce

    parts = mesh.size(axes)
    full = block.new_zeros((parts * block.shape[0], *block.shape[1:]))
    start = mesh.index(axes) * block.shape[0]
    full[start:start + block.shape[0]] = block
    return all_reduce(full, mesh.group(axes))
