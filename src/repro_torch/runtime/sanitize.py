"""Runtime sanitizers for the batch serving path; the port of
``repro.runtime.sanitize``.

Two guards turn serving-stack performance contracts into checks:

* :class:`CompileGuard` counts what a warm stream must not do again:
  executable-cache misses of ``BatchSolver`` (each miss builds a bucket
  pipeline, the counterpart of an XLA compile) and kernel builds (``nvcc``
  runs of ``kernels._build``).  A warm ``solve_stream`` pass over a bucket
  mix it has served before must count **zero**; ``CompileGuard(
  max_compiles=0)`` raises :class:`RecompileError` otherwise.

* :func:`no_implicit_transfers` runs a region under
  ``torch.cuda.set_sync_debug_mode("error")``: any operation that waits
  for the card from the host (a ``float()``/``.item()``, a copy to or
  from the host, an ``eigvalsh``) raises.  :func:`sanctioned` suspends it
  around the transfers the serving path means to make: the stacking
  upload and the one host read a window (:func:`host_read`).  Without a
  card both are no-ops: there is nothing to synchronise with.

``BatchSolver.solve_stream`` reports the compile count of every pass in
``last_stream_stats["compiles"]`` and runs its pipelines under the
transfer guard with ``BatchSolver(..., transfer_sanitize=True)``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from ..kernels import _build

_counts = {"cache_misses": 0}
_lock = threading.Lock()


def note_cache_miss() -> None:
    """Record one executable-cache miss (a bucket pipeline built)."""
    with _lock:
        _counts["cache_misses"] += 1


def compile_counts() -> dict:
    """Process-lifetime counters: ``compiles`` = ``cache_misses`` +
    ``kernel_builds``."""
    with _lock:
        misses = _counts["cache_misses"]
    builds = _build.builds
    return {"compiles": misses + builds, "cache_misses": misses,
            "kernel_builds": builds}


class RecompileError(RuntimeError):
    """A guarded region built more than its budget."""


class CompileGuard:
    """Count cache misses and kernel builds across a ``with`` region.

    >>> with CompileGuard(max_compiles=0) as guard:
    ...     solver.solve_stream(lps)      # warm: must not build
    >>> guard.compiles
    0

    ``max_compiles=None`` only counts; an int budget raises
    :class:`RecompileError` on exit when exceeded.
    """

    def __init__(self, max_compiles: Optional[int] = None,
                 label: str = "guarded region"):
        self.max_compiles = max_compiles
        self.label = label
        self.compiles = 0
        self.cache_misses = 0
        self.kernel_builds = 0
        self._start: Optional[dict] = None

    def __enter__(self) -> "CompileGuard":
        self._start = compile_counts()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = compile_counts()
        self.compiles = end["compiles"] - self._start["compiles"]
        self.cache_misses = end["cache_misses"] - self._start["cache_misses"]
        self.kernel_builds = (end["kernel_builds"]
                              - self._start["kernel_builds"])
        if exc_type is None and self.max_compiles is not None and \
                self.compiles > self.max_compiles:
            raise RecompileError(
                f"{self.label}: {self.cache_misses} executable-cache "
                f"miss(es) and {self.kernel_builds} kernel build(s), "
                f"budget {self.max_compiles} — a cache key drifted (stale "
                f"opts_static field? drifting shape signature?)")
        return False


_guards = 0      # open no_implicit_transfers regions


@contextlib.contextmanager
def _sync_debug_mode(mode):
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def no_implicit_transfers():
    """Raise on any host synchronisation inside the region (a no-op
    without a card)."""
    global _guards
    if not torch.cuda.is_available():
        yield
        return
    _guards += 1
    try:
        with _sync_debug_mode("error"):
            yield
    finally:
        _guards -= 1


@contextlib.contextmanager
def sanctioned():
    """Suspend :func:`no_implicit_transfers` around a transfer the
    serving path means to make (a no-op outside one)."""
    if _guards == 0:
        yield
        return
    with _sync_debug_mode("default"):
        yield


def host_read(flag: torch.Tensor) -> bool:
    """The one sanctioned host read of a window: ``bool(flag)``."""
    with sanctioned():
        return bool(flag)
