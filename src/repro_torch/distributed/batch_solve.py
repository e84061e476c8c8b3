"""Solver-as-a-service: many independent LPs solved data-parallel; the
port of ``repro.distributed.batch_solve``.

A *batch* of problem instances (same padded shape) is split over the
ranks of the mesh's ``batch_axes`` and each rank runs the dense bucket
pipeline (``runtime.batch.make_bucket_pipeline``) on its share: no
collective during the solve, one gather at the end.  The serving
configuration for LP-as-a-service (the paper's framing of RRAM arrays as
shared linear-optimization accelerators).

Heterogeneous streams should use ``runtime.solve_stream`` (which takes
the same ``mesh``); this module keeps the explicit same-shape API for
callers that already stacked their problems.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core import engine
from ..core.pdhg import PDHGOptions, torch_dtype
from ..runtime.batch import (
    lane_seed,
    make_bucket_pipeline,
    seeded_lane_draws,
)
from ..runtime.batch import stack_problems  # noqa: F401  (re-export)
from .sharding import gather_blocks


def solve_batch(
    Ks, bs, cs, lbs, ubs,
    mesh,
    opts: PDHGOptions = PDHGOptions(),
    batch_axes: Tuple[str, ...] = ("data",),
) -> dict:
    """Solve a stacked batch of standard-form LPs on every rank of
    ``mesh`` (each calls it with the same stack).

    Ks: (B, m, n); bs: (B, m); cs/lbs/ubs: (B, n).  B must be a multiple
    of the product of ``batch_axes`` sizes; this rank solves its
    contiguous share of the lanes.  Lane i draws its start from a
    generator seeded ``runtime.batch.lane_seed(opts.seed, i)``, so the
    results do not depend on the mesh.  Every rank returns the whole
    batch's results."""
    B = int(np.shape(Ks)[0])
    if any(int(np.shape(a)[0]) != B for a in (bs, cs, lbs, ubs)):
        raise ValueError("stacked arrays disagree on the batch size: "
                         f"{[np.shape(a) for a in (Ks, bs, cs, lbs, ubs)]}")
    parts = mesh.size(batch_axes)
    if B % parts:
        raise ValueError(f"batch of {B} does not split over {batch_axes} "
                         f"({parts} ranks)")
    share = B // parts
    lo = mesh.index(batch_axes) * share
    dev, dt = mesh.device, torch_dtype(opts.dtype)
    _, m, n = np.shape(Ks)
    arrays = [torch.as_tensor(np.asarray(a)[lo:lo + share], dtype=dt,
                              device=dev) for a in (Ks, bs, cs, lbs, ubs)]
    draws = seeded_lane_draws([lane_seed(opts.seed, i)
                               for i in range(lo, lo + share)], m, n, dt, dev)
    pipeline = make_bucket_pipeline(opts, device=dev)
    (xs, ys, its, merits, _rhos), _ = engine.drain(
        pipeline.run(arrays, draws))
    xs, ys, its, merits = (gather_blocks(t, mesh, batch_axes)
                           for t in (xs, ys, its, merits))
    merits = merits.cpu().numpy()
    return {
        "x": xs.cpu().numpy(),
        "y": ys.cpu().numpy(),
        "iterations": its.cpu().numpy(),
        "merit": merits,
        "converged": merits <= opts.tol,
    }
