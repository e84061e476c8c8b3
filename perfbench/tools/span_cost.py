#!/usr/bin/env python3
"""What recording the program's spans costs one cell's requests, and
where the card idles in a traced request.

    python3 perfbench/tools/span_cost.py --workload <cell> [--pairs 2]

On the card: the cell's set-up as ``run.py`` does it, then requests in
turns with recording off and on (``repro_torch.spans.recording()``, the
profiler off: off, on, on, off, ...), then one request under the
harness's CUDA-only trace.  Prints one JSON line: each request's wall
time, the traced request's wall and busy time, host seconds by span,
the device's idle seconds by the span open on the host at each gap's
middle, and the shares the benchmark's span metrics read.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]


def _timed(request, k):
    import torch

    t = time.perf_counter()
    request(k)
    torch.cuda.synchronize()
    return time.perf_counter() - t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    from perfbench.harness import program_spans, runner, spec, trace
    from repro_torch import spans

    cell = spec.load_cell(args.workload)
    runner.require_cards(cell.chips)
    entry = spec.entry_class(cell)(cell.config, cell.traffic,
                                   torch.device("cuda"))
    entry.generate(args.seed)
    entry.warm()
    torch.cuda.synchronize()
    off, on, k = [], [], 0
    for i in range(args.pairs):
        for rec in ((False, True) if i % 2 == 0 else (True, False)):
            if rec:
                with spans.recording():
                    on.append(_timed(entry.request, k))
            else:
                off.append(_timed(entry.request, k))
            k += 1
    with trace.profiled() as h:
        entry.request(k)
    device, host = trace.events(h.prof)
    summary = trace.summarize(device, host, h.window_s)
    recs = spans.records()
    shares = {name: program_spans.host_seconds(recs, names)
              for name, names in (
                  ("stack", ("serve.group", "serve.stack", "serve.upload")),
                  ("prep", ("solve.prepare", "solve.norm")),
                  ("host_wait", ("loop.read",)))}
    out = {"cell": cell.name, "device": torch.cuda.get_device_name(),
           "off_s": off, "on_s": on, "traced_s": h.window_s,
           "busy_s": summary and summary["busy_s"],
           "ranges_in_trace": sorted({r[2] for r in host}
                                     & {r["name"] for r in recs}),
           "seconds_by_span": spans.seconds_by_name(recs),
           "idle_by_span": spans.idle_by_span(device, recs),
           "share_s": shares, "counters": spans.counters()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
