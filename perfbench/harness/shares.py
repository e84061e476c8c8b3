"""Arithmetic the metrics share, so that a dense and a stream variant of
one quantity read it alike: the rate of LPs, the mean iterations, the
share of lane-iterations that were useful, the least time the traced request's steps need at HBM's rate, and shares of
the traced window."""
from __future__ import annotations

from typing import Optional

from ..yardstick import peaks, step_bytes
from . import lp


def lp_rate(ctx) -> float:
    """LPs that reached the tolerance, over the wall time of the whole
    requests the window held."""
    return sum(ctx.entry.reached(a) for a in ctx.answers) / ctx.total_s


def mean_iterations(ctx) -> float:
    """The mean of each LP's own iterations over the window."""
    answers = ctx.answers
    return sum(a.iterations for a in answers) / len(answers)


def lane_useful_share(ctx) -> Optional[float]:
    """The LPs' own iterations over the lane-iterations the buckets
    executed (each bucket's lanes times its windows times the window's
    steps, from ``BatchSolver.last_stream_stats["bucket_windows"]`` of
    every pass), in %."""
    own = executed = 0
    for r in ctx.requests:
        info = r.out.info
        if "bucket_windows" not in info:
            return None
        own += sum(a.iterations for a in r.out.answers)
        executed += sum(b["lanes"] * b["windows"] * info["check_every"]
                        for b in info["bucket_windows"])
    return 100.0 * own / executed if executed else None


def least_step_seconds(ctx) -> float:
    """Sum over the traced request's LPs of their own iterations times
    the bytes one step of that LP needs (``yardstick.step_bytes``), at
    3.35 TB/s."""
    size = lp.DTYPE_BYTES[ctx.cell.config["dtype"]]
    total = 0
    for a in ctx.traced.out.answers:
        inst = ctx.entry.pool[a.index]
        m, n = inst.shape
        nnz = inst.K.nnz if hasattr(inst.K, "row") else None
        total += a.iterations * step_bytes.step_bytes(m, n, size, nnz)
    return total / peaks.HBM_BYTES_PER_S


def hbm_share(ctx) -> Optional[float]:
    """The least time over the device-busy time of the trace, in %."""
    if ctx.trace is None or ctx.trace["busy_s"] <= 0:
        return None
    return 100.0 * least_step_seconds(ctx) / ctx.trace["busy_s"]


def idle_share(ctx) -> Optional[float]:
    """The share of a request's wall time with nothing on the device, in
    %: one minus the traced request's device-busy time over the pace of
    the window's untraced requests (the same work; the traced request
    itself runs slower by what the profiler costs)."""
    if ctx.trace is None or not ctx.requests:
        return None
    pace = ctx.total_s / len(ctx.requests)
    return 100.0 * (1.0 - ctx.trace["busy_s"] / pace)
