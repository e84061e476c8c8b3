"""Spans and counters of the port: where a solve, its loop and the
serving layer spend their time, stamped on the profiler's clock.

    with spans.span("solve.prepare"):
        ...
    with spans.span("loop.window", device=dev) as w:
        ...
        w.set("mode", "replay")

A span records only while recording is on: while a ``torch.profiler``
session is active (``torch.autograd._profiler_enabled()``, so a traced
request records with no change to its caller) or inside ``recording()``.
Off, ``span`` costs one flag check and returns a shared do-nothing
context.

A record holds the span's name, its id, the id of its parent (the
innermost span open on the same thread when it opened), the id of its
root (the outermost one: its request), its start and end in Unix-epoch
nanoseconds (``time.time_ns()``, the clock the profiler converts its own
stamps to), its attributes and, for a span opened with ``device``, its
device seconds.  While recording on a card, such a span also records a
CUDA event on the current stream at entry and at exit (never inside a
graph capture): its device seconds are the time that stream took from
the span's first launch to its last, gaps between queued kernels
included.  On the CPU, where every operation is synchronous, they are
the host seconds.  While the profiler is on, each span also opens a
``torch.profiler.record_function`` range of its name.

Records stay in memory, in a store of at most ``MAX_RECORDS``; those
past it are counted in ``counters()["dropped"]``.  A stretch of
recording begins when ``recording()`` is entered with recording off, or
when a span finds recording on after one that found it off; it empties
the store and the counters, so that ``records()`` and ``counters()``
hold the latest stretch only (two profiler sessions with no span
between them are one stretch).

``timed(name)`` is a span that always takes its stamps, recording or
not: ``seconds`` holds its length after it closed (the serving layer's
``dispatch_s`` and ``collect_s``).

``idle_by_span`` puts the device's idle time down to the innermost span
open on the host at each gap's middle: the join of a trace's device
intervals with the records.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import Counter
from typing import Iterable

import numpy as np
import torch

MAX_RECORDS = 1 << 18
HOST = "host"          # idle time under no span

_profiling = torch.autograd._profiler_enabled
_forced = 0            # depth of open ``recording()`` contexts
_live = False          # whether the last check found recording on
_store: list = []      # closed spans of the current stretch
_dropped = 0
_counts: Counter = Counter()
_ids = itertools.count(1)
_local = threading.local()


def _begin() -> None:
    global _dropped
    _store.clear()
    _counts.clear()
    _dropped = 0


def _recording() -> bool:
    global _live
    on = bool(_forced) or _profiling()
    if on and not _live:
        _begin()
    _live = on
    return on


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """The span while recording is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value) -> None:
        pass


_OFF = _Off()


class Span:
    """One span while it records (or, made by ``timed``, while it only
    times itself)."""

    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns",
                 "end_ns", "device", "events", "rf", "record", "seconds")

    def __init__(self, name: str, attrs: dict, device, record: bool):
        self.name, self.attrs, self.device = name, attrs, device
        self.record = record
        self.events = self.rf = self.id = self.parent = self.root = None
        self.seconds = None

    def set(self, key, value) -> None:
        """Set an attribute of the record."""
        self.attrs[key] = value

    def __enter__(self):
        if self.record:
            stack = _stack()
            self.id = next(_ids)
            self.parent = stack[-1].id if stack else None
            self.root = stack[0].id if stack else self.id
            stack.append(self)
            if _profiling():
                self.rf = torch.autograd.profiler.record_function(self.name)
                self.rf.__enter__()
            if (self.device is not None and self.device.type == "cuda"
                    and not torch.cuda.is_current_stream_capturing()):
                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                self.events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        self.end_ns = time.time_ns()
        self.seconds = (self.end_ns - self.start_ns) / 1e9
        if not self.record:
            return False
        if self.events is not None:
            if torch.cuda.is_current_stream_capturing():
                self.events = None
            else:
                self.events[1].record()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None
        _stack().pop()
        if len(_store) < MAX_RECORDS:
            _store.append(self)
        else:
            _dropped += 1
        return False


def span(name: str, device=None, **attrs):
    """A context manager around one stretch of work.  ``device`` (the
    torch device the work runs on) asks for the device seconds as well.
    Records only while recording is on."""
    if not _recording():
        return _OFF
    return Span(name, attrs, None if device is None
                else torch.device(device), True)


def timed(name: str, **attrs) -> Span:
    """A span that always times itself (``seconds`` after it closed) and
    records as ``span`` does."""
    return Span(name, attrs, None, _recording())


def count(key: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``key`` while recording is on."""
    if _recording():
        _counts[key] += n


@contextlib.contextmanager
def recording():
    """Record spans inside the body, with the profiler on or off (a
    stretch of its own unless recording was on already)."""
    global _forced, _live
    if not (_forced or _profiling()):
        _begin()
        _live = True
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1
        _live = bool(_forced) or _profiling()


def _as_record(s: Span, synced: bool) -> dict:
    host_s = (s.end_ns - s.start_ns) / 1e9
    device_s = None
    if s.device is not None:
        if s.device.type != "cuda":
            device_s = host_s
        elif s.events is not None and synced:
            device_s = s.events[0].elapsed_time(s.events[1]) / 1e3
    return {"name": s.name, "id": s.id, "parent": s.parent, "root": s.root,
            "start_ns": s.start_ns, "end_ns": s.end_ns,
            "attrs": dict(s.attrs), "device_s": device_s}


def records() -> list:
    """The records of the latest stretch of recording, in the order the
    spans closed (a list of dicts; see the module's docstring)."""
    synced = any(s.events is not None for s in _store)
    if synced:
        torch.cuda.synchronize()
    return [_as_record(s, synced) for s in _store]


def counters() -> dict:
    """The latest stretch's counts (windows by mode, host reads,
    stacking bytes by path, records dropped) and a snapshot of the
    process's own counters: ``engine.GRAPHS``, ``kernels.launch_counts``
    and ``sanitize.compile_counts``, which keep counting where they
    are."""
    from .core import engine
    from .kernels import launch_counts
    from .runtime import sanitize

    out: dict = {"windows": {}, "host_reads": 0, "stack_bytes": {}}
    for key, n in sorted(_counts.items()):
        group, _, sub = key.partition(".")
        if sub:
            out.setdefault(group, {})[sub] = n
        else:
            out[group] = n
    out["dropped"] = _dropped
    out["graphs"] = dict(engine.GRAPHS)
    out["launches"] = launch_counts()
    out["compiles"] = sanitize.compile_counts()
    return out


def seconds_by_name(recs: Iterable[dict]) -> dict:
    """Host seconds summed by span name."""
    out: dict = {}
    for r in recs:
        out[r["name"]] = out.get(r["name"], 0.0) + (
            r["end_ns"] - r["start_ns"]) / 1e9
    return out


def _timeline(recs: list):
    """``(bounds, labels)``: from ``bounds[i]`` on, the innermost span
    open is ``labels[i]`` (None: none).  Spans nest on one thread; a
    child that outlasts its parent is cut at the parent's end."""
    order = sorted(recs, key=lambda r: (r["start_ns"], -r["end_ns"]))
    bounds, labels, stack = [], [], []

    def close_until(t):
        while stack and stack[-1][0] <= t:
            end, _ = stack.pop()
            bounds.append(end)
            labels.append(stack[-1][1] if stack else None)

    for r in order:
        s, e = r["start_ns"], r["end_ns"]
        close_until(s)
        if stack:
            e = min(e, stack[-1][0])
        stack.append((e, r["name"]))
        bounds.append(s)
        labels.append(r["name"])
    close_until(float("inf"))
    return np.asarray(bounds, np.int64), labels


def idle_by_span(device: Iterable, recs: list, host: str = HOST) -> dict:
    """The device's idle seconds by the innermost span open on the host
    at each gap's middle (``host`` where none was).  ``device`` holds
    ``(start_ns, end_ns)`` intervals of the device's work; the gaps are
    those of their union, and before the first and after the last up to
    the records' first start and last end."""
    dev = np.asarray([(int(a), int(b)) for a, b, *_ in device],
                     np.int64).reshape(-1, 2)
    t0 = [r["start_ns"] for r in recs] + dev[:, 0].tolist()
    t1 = [r["end_ns"] for r in recs] + dev[:, 1].tolist()
    if not t0:
        return {}
    order = np.argsort(dev[:, 0], kind="stable")
    s, e = dev[order, 0], np.maximum.accumulate(dev[order, 1])
    gap_s = np.r_[min(t0), e]
    gap_e = np.r_[s, max(t1)]
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    bounds, labels = _timeline(recs)
    names = sorted({n for n in labels if n is not None} | {host})
    ids = np.asarray([names.index(host if n is None else n)
                      for n in labels] + [names.index(host)], np.int64)
    # a gap before the first bound is under no span: the last id
    at = np.searchsorted(bounds, (gap_s + gap_e) // 2, side="right") - 1
    sums = np.bincount(ids[at], weights=(gap_e - gap_s).astype(np.float64),
                       minlength=len(names))
    return {n: float(v) / 1e9 for n, v in zip(names, sums) if v > 0}
