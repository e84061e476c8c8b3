"""Shares of the traced request read from the program's own spans
(``repro_torch.spans``).

The program records its spans while a profiler is on, and only the
traced request runs under one, so the records the program holds after
the run are that request's.  A program without spans gives None, and
the metric is left out of the line.  Each share is in %:

* of the traced request's wall time (``ctx.traced.wall_s``): the host
  seconds spent in spans of some names, each second counted once (a
  span inside another of the same names is not counted again);
* ``check_share``: the device seconds of the loop's checks over those of
  its windows and checks.
"""
from __future__ import annotations

from typing import Optional

WINDOW = "loop.window"
CHECK = "loop.check"


def records() -> Optional[list]:
    """The program's records of the traced request, or None."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.records() or None


def host_seconds(recs: list, names) -> Optional[float]:
    """Host seconds in the spans named ``names``, a span inside another
    of them left out; None when there is no such span."""
    names = set(names)
    by_id = {r["id"]: r for r in recs}
    total, found = 0, False
    for r in recs:
        if r["name"] not in names:
            continue
        found = True
        p = by_id.get(r["parent"])
        while p is not None and p["name"] not in names:
            p = by_id.get(p["parent"])
        if p is None:
            total += r["end_ns"] - r["start_ns"]
    return total / 1e9 if found else None


def wall_share(ctx, names) -> Optional[float]:
    """Host seconds in ``names`` over the traced request's wall time."""
    recs = records() if ctx.traced is not None else None
    if recs is None or ctx.traced.wall_s <= 0:
        return None
    s = host_seconds(recs, names)
    return None if s is None else 100.0 * s / ctx.traced.wall_s


def check_share(ctx) -> Optional[float]:
    """Device seconds of ``loop.check`` over those of ``loop.window`` and
    ``loop.check``."""
    recs = records() if ctx.traced is not None else None
    if recs is None:
        return None
    dev = {WINDOW: 0.0, CHECK: 0.0}
    for r in recs:
        if r["name"] in dev and r["device_s"] is not None:
            dev[r["name"]] += r["device_s"]
    total = dev[WINDOW] + dev[CHECK]
    return 100.0 * dev[CHECK] / total if total > 0 else None
