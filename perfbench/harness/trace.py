"""The device trace of a ``--trace 1`` run.

The harness traces one whole request, after the measured window, with
``torch.profiler``, CUDA activity alone: no operator of the host is
recorded, so the trace costs the host no more than the CUDA runtime's
callbacks and CUPTI's record of each kernel.  ``window_s`` is that
request's wall time on the host's clock, from a synchronize before it
to one after it.  From the raw Kineto events:

* the device intervals: every event on the card (kernels, copies,
  sets);
* ``busy_s``: the length of their union; ``window_s``: the window;
* ``device_ops``: device seconds summed by name, the largest first;
* ``idle_gaps``: the longest gaps of the union inside the trace's span,
  each named by the CUDA runtime call the host was in at its middle
  (``host`` where it was in none: Python or NumPy work), with the gap's
  start in seconds from the trace's first event.
"""
from __future__ import annotations

import contextlib
import time
import types
from typing import Optional

import numpy as np
import torch

TOP = 10
HOST = "host"
# the card's copies of host annotations, should the profiler make any
MIRRORS = ("gpu_user_annotation",)


@contextlib.contextmanager
def profiled():
    """Trace the body (the one traced request); yields a holder whose
    ``prof`` is the finished profiler and ``window_s`` the body's wall
    time."""
    holder = types.SimpleNamespace(prof=None, window_s=None)
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CUDA if cuda
            else torch.profiler.ProfilerActivity.CPU]
    prof = torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)
    with prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield holder
        if cuda:
            torch.cuda.synchronize()
        holder.window_s = time.perf_counter() - t0
    holder.prof = prof


def events(prof):
    """``(device, host)``: rows (start_ns, end_ns, name) of the events on
    the card and of the host's (the CUDA runtime's calls)."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        row = (start, start + e.duration_ns(), e.name())
        if e.device_type() != cuda:
            host.append(row)
        elif getattr(e, "activity_type", lambda: None)() not in MIRRORS:
            device.append(row)
    return device, host


def _union(starts, ends):
    """Merged, sorted intervals of the given ones."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.empty(s.size, bool)
    new[0] = True
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    last = np.r_[idx[1:] - 1, s.size - 1]
    return s[idx], run_end[last]


def _label(hs, he, names, t) -> str:
    """The innermost (shortest) host call that covers time ``t``."""
    hit = np.flatnonzero((hs <= t) & (he >= t))
    if hit.size == 0:
        return HOST
    return names[hit[np.argmin(he[hit] - hs[hit])]]


def summarize(device, host, window_s: float,
              top: int = TOP) -> Optional[dict]:
    """The trace's numbers, or None when no operation ran on the
    device."""
    if not device or window_s <= 0:
        return None
    starts = np.array([d[0] for d in device], np.int64)
    ends = np.array([d[1] for d in device], np.int64)
    us, ue = _union(starts, ends)
    busy_ns = int(np.sum(ue - us))
    by_name: dict = {}
    for s, e, n in device:
        by_name[n] = by_name.get(n, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # the trace's span: its first event to its last, host calls included
    w0 = min([int(us[0])] + [h[0] for h in host])
    w1 = max([int(ue[-1])] + [h[1] for h in host])
    gap_s = np.r_[w0, ue]
    gap_e = np.r_[us, w1]
    lens = gap_e - gap_s
    longest = np.argsort(-lens, kind="stable")[:top]
    hs = np.array([h[0] for h in host], np.int64)
    he = np.array([h[1] for h in host], np.int64)
    names = [h[2] for h in host]
    gaps = []
    for i in longest:
        if lens[i] <= 0:
            break
        mid = (gap_s[i] + gap_e[i]) // 2
        at = (gap_s[i] - w0) / 1e9
        gaps.append([f"{_label(hs, he, names, mid)} at {at:.3f} s",
                     float(lens[i]) / 1e9])
    return {"busy_s": busy_ns / 1e9, "window_s": float(window_s),
            "device_ops": [[n, v / 1e9] for n, v in ops],
            "idle_gaps": gaps}
