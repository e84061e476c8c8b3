#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the kernels loaded from ``build/``, the cell's instances made
from its configuration and ordered by ``--seed``, its shapes warmed),
then a window of whole requests for ``--seconds``, then the judge.  The
last line of standard output is the result; the numbers compared for
``correct`` are the last lines of standard error.  Without a CUDA card
(or with fewer than the cell asks for) it prints no result and exits 2;
if JAX or the JAX package was loaded, it exits 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# the program's caches at fixed paths inside the checkout; host threads
# few and fixed, so that the run's host work repeats
for key, value in (("TRITON_CACHE_DIR", REPO / "build" / "triton"),
                   ("CUDA_CACHE_PATH", REPO / "build" / "cuda-cache"),
                   ("OMP_NUM_THREADS", 4), ("OPENBLAS_NUM_THREADS", 4),
                   ("MKL_NUM_THREADS", 4)):
    os.environ[key] = str(value)
sys.path[:0] = [str(REPO), str(REPO / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from perfbench.harness import runner, spec

    try:
        cell = spec.load_cell(args.workload)
        runner.require_cards(cell.chips)
        runner.run(cell, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START)
    except runner.NoResult as e:
        print(f"perfbench: no result: {e}", file=sys.stderr)
        return e.code
    return 0


if __name__ == "__main__":
    sys.exit(main())
