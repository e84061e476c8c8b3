"""Run one cell once: set up, measure a window of whole requests, judge
every answer against the reference, read the cell's metrics and print
the result line (the last line of standard output), with each number
compared beside its limit (the last lines of standard error)."""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import sys
import time
from typing import Optional

from . import spec, trace
from .window import Request, run_window

# top-level module names that may not be loaded in the process that
# prints the result: JAX, its libraries, the JAX package, and the
# reference's own benchmarks (compared whole: ``repro_torch`` is not
# ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


class NoResult(Exception):
    """The run cannot give a result; the message says why and ``code``
    is the process's exit code."""

    def __init__(self, message: str, code: int = 2):
        super().__init__(message)
        self.code = code


def forbidden_modules(names=None) -> list:
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def require_cards(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise NoResult("no CUDA card: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise NoResult(f"the cell needs {chips} card(s); "
                       f"{torch.cuda.device_count()} visible")


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    cell: spec.Cell
    entry: object
    requests: list              # window.Request, out = lp.Served
    total_s: float              # wall time of the window's requests
    setup_s: float
    trace: Optional[dict]       # trace.summarize(...) of the traced request
    traced: Optional[object]    # the traced request, after the window

    @property
    def answers(self):
        """The window's answers (the traced request's are judged, not
        counted in the window's metrics)."""
        return [a for r in self.requests for a in r.out.answers]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def judge(cell: spec.Cell, entry, answers):
    """``(checks, failed)``: each compared number's worst reading beside
    its limit, and the answers that did not reach the traffic's goal or
    read above a limit."""
    limits = {k: float(v["limit"]) for k, v in cell.checks.items()}
    worst = {k: -math.inf if answers else math.inf for k in limits}
    failed = 0
    # answers to one instance together: the judge scales each once
    for a in sorted(answers, key=lambda a: a.index):
        r = entry.readings(a)
        bad = not entry.reached(a)
        for k, lim in limits.items():
            v = float(r.get(k, math.inf))
            worst[k] = max(worst[k], v)
            bad |= not v <= lim
        failed += bad
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    return checks, failed


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, *,
        t_start: float, device: str = "cuda", out=None, err=None) -> dict:
    """One run; returns the result (also printed).  ``device`` other than
    ``cuda`` serves the CPU tests of the harness only."""
    import torch

    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    dev = torch.device(device)
    entry = spec.entry_class(cell)(cell.config, cell.traffic, dev)
    entry.generate(seed)
    entry.warm()
    _sync(dev)
    setup_s = time.perf_counter() - t_start

    def request(k):
        served = entry.request(k)
        _sync(dev)
        return served

    requests, total_s = run_window(request, seconds)
    traced_req = None
    if traced:
        # one more request, traced, after the window closed: what the
        # profiler costs (CUPTI records each kernel a graph replays)
        # stays out of the window, whose untraced pace the idle share
        # is read against
        with trace.profiled() as h:
            served = request(len(requests))
        traced_req = Request(len(requests), total_s, h.window_s, served)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    entry.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    summary = None
    if traced:
        t = time.perf_counter()
        device_rows, host_rows = trace.events(h.prof)
        summary = trace.summarize(device_rows, host_rows, h.window_s)
        print(f"trace: {len(device_rows)} device and {len(host_rows)} host "
              f"events read in {time.perf_counter() - t:.1f} s", file=err)
    ctx = Context(cell, entry, requests, total_s, setup_s, summary,
                  traced_req)
    answers = ctx.answers + (traced_req.out.answers if traced else [])
    checks, failed = judge(cell, entry, answers)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = spec.metric_reader(cell, m)(ctx)
        if v is not None:
            metrics[m.name] = {"value": float(v), "unit": m.unit}
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(answers) and all(
                  c["value"] <= c["limit"] for c in checks.values()),
              "attempted": len(answers), "failed": failed,
              "metrics": metrics, "device": info}
    if traced:
        if summary is not None:
            info["busy_s"] = summary["busy_s"]
            info["window_s"] = summary["window_s"]
            result["breakdown"] = {"device_ops": summary["device_ops"],
                                   "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        raise NoResult(f"modules loaded that the benchmark may not load: "
                       f"{bad}", code=3)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=err)
    print(json.dumps(result), file=out, flush=True)
    return result
