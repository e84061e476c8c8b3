"""Departures from the crossbar model, planted in the program, that the
judge of a crossbar cell must read as not correct.

Each departure is a function of ``patch(obj, name, value)`` (pytest's
``monkeypatch.setattr``, or ``planted``'s own) that replaces one piece of
the program:

* ``read_noise_off``: every analog product returned exact;
* ``read_noise_quarter``, ``read_noise_tenth``: the read noise drawn at a
  quarter, a tenth of the device's ``sigma_read``;
* ``read_noise_every_other``: the noise left off every other product,
  which, a step making its forward and then its adjoint product, leaves
  it on the forward products alone; the answer's residuals stay at the
  same floor, and no number of the judge sees it (``UNSEEN``);
* ``program_error_off``: the tier programmed with its quantization alone;
* ``quantization_off``: the tier programmed without rounding to levels;
* ``budget_halved``: each solve given half its iteration budget;
* ``altered_answer``: x half as large again where the solve returns it;
* ``uncharged_mvm``: one MVM of each solve left out of its read ledger.

The program's float32 path, the cell's control, is no departure here:
``tools/readings.py --control`` runs it.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np


def read_noise_off(patch):
    from repro_torch.core import engine

    patch(engine, "_read_noise", lambda w, generator, sigma_read: w)


def _scaled_read_noise(patch, factor):
    from repro_torch.core import engine

    noise = engine._read_noise
    patch(engine, "_read_noise", lambda w, generator, sigma_read: noise(
        w, generator, sigma_read * factor))


def read_noise_quarter(patch):
    _scaled_read_noise(patch, 0.25)


def read_noise_tenth(patch):
    _scaled_read_noise(patch, 0.1)


def read_noise_every_other(patch):
    from repro_torch.core import engine

    noise = engine._read_noise
    calls = [0]

    def every_other(w, generator, sigma_read):
        calls[0] += 1
        return noise(w, generator, sigma_read) if calls[0] % 2 else w

    patch(engine, "_read_noise", every_other)


def program_error_off(patch):
    from repro_torch.crossbar import encode

    core = encode.encode_core

    def exact_programming(W, generator, g_levels, sigma_program, **kw):
        return core(W, generator, g_levels, 0.0, **kw)

    patch(encode, "encode_core", exact_programming)


def quantization_off(patch):
    from repro_torch.crossbar import encode

    patch(encode, "_quantize_", lambda g, levels: g)


def budget_halved(patch):
    from repro_torch.core import pdhg

    solve_jit = pdhg.solve_jit

    def half(lp, opts, *a, **k):
        return solve_jit(lp, dataclasses.replace(
            opts, max_iters=opts.max_iters // 2), *a, **k)

    patch(pdhg, "solve_jit", half)


def altered_answer(patch):
    from repro_torch.core import pdhg

    solve_jit = pdhg.solve_jit

    def bent(*a, **k):
        res = solve_jit(*a, **k)
        return dataclasses.replace(res, x=1.5 * np.asarray(res.x))

    patch(pdhg, "solve_jit", bent)


def uncharged_mvm(patch):
    from repro_torch.crossbar import solver

    charge = solver._charge_reads

    def short(ledger, device, n_mvms, active_cells):
        charge(ledger, device, n_mvms - 1, active_cells)

    patch(solver, "_charge_reads", short)


DEPARTURES = {f.__name__: f for f in (
    read_noise_off, read_noise_quarter, read_noise_tenth, program_error_off, quantization_off, budget_halved,
    altered_answer, uncharged_mvm)}


# planted and read, but not seen by the judge (PERF.md, section 7)
UNSEEN = {f.__name__: f for f in (read_noise_every_other,)}


@contextlib.contextmanager
def planted(name: str):
    """The departure ``name`` planted for the body, undone after it."""
    undo = []

    def patch(obj, attr, value):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    try:
        {**DEPARTURES, **UNSEEN}[name](patch)
        yield
    finally:
        for obj, attr, old in reversed(undo):
            setattr(obj, attr, old)
