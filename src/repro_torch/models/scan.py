"""Loops that the dry run counts from their trips (port only).

The reference's recurrences are ``lax.scan`` loops: RWKV6's token scan
(``models/rwkv6.py``) and the chunked SSM's loop over chunks
(``models/ssm.py``), whose bodies XLA compiles once and
``launch/hlo.py`` scales by their trip counts.  The port's are Python
loops.  ``scan`` runs one as the plain loop, and inside
``counted_scans`` (the dry run's counting mode) runs its body twice and
has the counter count the second run as the other n - 1 trips, forward
and backward.
"""
from __future__ import annotations

import contextlib

import torch

from ..runtime.mesh import constrain, per_rank

_COUNTERS: list = []


@contextlib.contextmanager
def counted_scans(counter):
    """Inside the block ``scan`` runs its body twice and has ``counter``
    count it as ``n`` trips: the dry run's counting mode, whose
    ``repeated(n)`` scales every count it takes inside it by ``n``, as
    the reference's ``launch/hlo.py`` scales a ``lax.scan`` body's counts
    by its trip count."""
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.pop()


class _Trips(torch.autograd.Function):
    """Identity on its tensors whose backward multiplies the counter's
    scale by n (``enter``) or divides it by n: put on a scan body's
    outputs and on its inputs, it scales the body's backward as the
    forward is scaled."""

    @staticmethod
    def forward(ctx, counter, n, enter, *ts):
        ctx.counter, ctx.n, ctx.enter = counter, n, enter
        # a missing gradient is made here, shaped and placed as its
        # tensor: autograd's own zeros would be a plain tensor at the
        # global shape in the place of a DTensor's
        ctx.set_materialize_grads(False)
        ctx.inputs = ts
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.enter:
            ctx.counter.scale *= ctx.n
        else:
            ctx.counter.scale //= ctx.n
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, ctx.inputs)]
        return (None, None, None, *grads)


def scan(step, carry, xs, n: int):
    """``carry, y_t = step(carry, t, *xs)`` for t < n: (the last carry,
    the outputs stacked on dimension 1), as ``lax.scan`` over a leading
    axis of its inputs (RWKV6's tokens, the chunked SSM's chunks).

    On its own a Python loop over the n trips.  Inside ``counted_scans``
    the body runs twice: the first trip counted once (it also places the
    initial carry) and the second counted as the other n - 1, forward
    and backward; the carry keeps its full size, and the second output
    is copied n - 1 times into the stack, which is as large as the
    loop's and moves as many bytes."""
    if not _COUNTERS or n < 2:
        ys = []
        for t in range(n):
            carry, y = step(carry, t, *xs)
            ys.append(y)
        return carry, torch.stack(ys, dim=1)
    counter, trips = _COUNTERS[-1], n - 1
    carry, y0 = step(carry, 0, *xs)
    ins = [carry, *xs]
    live = [i for i, t in enumerate(ins)
            if torch.is_grad_enabled() and t.requires_grad]
    if live:
        for i, t in zip(live, _Trips.apply(counter, trips, False,
                                           *(ins[i] for i in live))):
            ins[i] = t
    with counter.repeated(trips):
        carry, y = step(ins[0], 1, *ins[1:])
    if live:
        carry, y = _Trips.apply(counter, trips, True, carry, y)
    y0, y = y0.unsqueeze(1), y.unsqueeze(1)
    return carry, torch.cat(
        [y0, y.expand(y.shape[0], trips, *y.shape[2:])], dim=1)


def scan_by_rank(step, carry, xs, n: int, *, carry_spec, xs_specs,
                 ys_spec, shapes, init=None):
    """``scan(step, carry, xs, n)`` of DTensors, run on each rank's blocks
    (``runtime.mesh.per_rank``): a recurrence over a rank's own batch
    rows and heads needs nothing of another rank, as GSPMD partitions
    the reference's ``lax.scan``.  The carry and each of ``xs`` are
    placed by ``carry_spec`` and ``xs_specs`` first (``constrain``); a
    ``carry`` of None is made on each rank by ``init(*its blocks of
    xs)``.  Returns the last carry and the outputs, of the global
    ``shapes``, placed by ``carry_spec`` and ``ys_spec``."""
    xs = tuple(constrain(x, *spec) for x, spec in zip(xs, xs_specs))
    out = [(carry_spec, shapes[0]), (ys_spec, shapes[1])]
    if carry is None:
        return per_rank(lambda *xs: scan(step, init(*xs), xs, n), *xs,
                        out=out)
    return per_rank(lambda carry, *xs: scan(step, carry, xs, n),
                    constrain(carry, *carry_spec), *xs, out=out)
