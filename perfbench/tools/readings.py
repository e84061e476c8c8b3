#!/usr/bin/env python3
"""The readings the limits of ``checks/<cell>.json`` are set from, on the
card at the cell's own sizes.

    python3 perfbench/tools/readings.py --cell dense-exact-tol \
        --program 0-3 --control 0-3

``--program``: the program through the cell's entry, in the precision
the configuration states, on the instances of these generator seeds
(the configuration's family and shapes, shapes cycling by position; for
a configuration that names its instances, each of them on each seed),
served as one pass of the pool.  ``--control``: the same with the program's own
float32 path switched on (the step below the float64 the configurations
state).  ``--plant``: a departure of ``tools/departures.py`` planted in
the program for its side (``--program``), such as ``read_noise_off`` on a
crossbar cell.  Each answer is judged as a run
judges it; one JSON line an answer, then the worst of each number and
the judge's verdict on each side.  ``--bench``: a JSON file with the
cell's entries of ``BENCHMARK.json``'s lists, for a cell that is not in
it yet (default: ``BENCHMARK.json``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(REPO), str(REPO / "src")]


def seeds(text: str):
    out = []
    for part in text.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out += list(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


def served(cell, device, pool_seeds=None, dtype=None):
    """One pass of the cell's entry over the instances of ``pool_seeds``
    (default: the configuration's), with the configuration's dtype
    replaced by ``dtype`` where given.  Returns ``(entry, served, wall
    seconds)``: the pass's answers and the last request's report."""
    import torch

    from perfbench.harness import lp, spec

    cfg = dict(cell.config)
    if pool_seeds is not None:
        names = cfg.get("instances")
        cfg["seeds"] = ([s for s in pool_seeds for _ in names] if names
                        else list(pool_seeds))
    if dtype is not None:
        cfg["dtype"] = dtype
    entry = spec.entry_class(cell)(cfg, cell.traffic, device)
    entry.generate(0)
    entry.warm()
    t = time.perf_counter()
    answers, info = [], {}
    for k in range(entry.pass_requests()):
        out = entry.request(k)
        answers += out.answers
        info = out.info
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t
    entry.release()
    return entry, lp.Served(answers, info), wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--program", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--plant", default=None)
    ap.add_argument("--bench", default=None)
    args = ap.parse_args(argv)

    import contextlib

    import torch

    from perfbench.harness import lp, runner, spec
    from perfbench.tools import departures
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = None
    if args.bench:
        with open(args.bench) as f:
            bench = json.load(f)
    cell = spec.load_cell(args.cell, bench)
    dev = torch.device("cuda")
    summary: dict = {}
    for who, text, dtype in (("program", args.program, None),
                             ("control", args.control, "float32")):
        ss = seeds(text)
        if not ss:
            continue
        plant = (departures.planted(args.plant)
                 if who == "program" and args.plant
                 else contextlib.nullcontext())
        with plant:
            entry, out, wall = served(cell, dev, ss, dtype)
        specs = lp.pool_specs(entry.config)
        worst: dict = {}
        for a in out.answers:
            r = entry.readings(a)
            for k, v in r.items():
                worst[k] = max(worst.get(k, 0.0), v)
            print(json.dumps({"who": who, "plant": args.plant,
                              "seed": specs[a.index]["seed"],
                              "instance": entry.pool[a.index].name,
                              "dtype": entry.config["dtype"],
                              "iterations": a.iterations,
                              "status": a.status,
                              "wall_s": a.extra.get("wall_s", wall),
                              "readings": r}), flush=True)
        if "bucket_windows" in out.info:
            print(json.dumps({"who": who, "bucket_windows":
                              out.info["bucket_windows"]}, default=str),
                  flush=True)
        checks, failed = runner.judge(cell, entry, out.answers)
        summary[who] = {"worst": worst, "checks": checks, "failed": failed,
                        "correct": all(c["value"] <= c["limit"]
                                       for c in checks.values()),
                        "pass_s": wall}
        torch.cuda.empty_cache()
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
