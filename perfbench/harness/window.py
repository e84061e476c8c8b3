"""The measured window: whole requests, one after another (a closed
loop of one client).  After each request the window starts another only
if that one, at the pace of the last, still ends within ``seconds``; the
first always runs.  Rates are taken over all the work and all the time
of the requests the window held."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List


@dataclasses.dataclass
class Request:
    k: int
    start_s: float          # from the window's start
    wall_s: float
    out: object


def run_window(request: Callable[[int], object], seconds: float,
               clock: Callable[[], float] = time.perf_counter):
    """Run ``request(k)`` for k = 0, 1, ... under the rule above;
    returns ``(requests, total_s)``."""
    t0 = clock()
    done: List[Request] = []
    k = 0
    while True:
        t = clock()
        out = request(k)
        t_end = clock()
        done.append(Request(k, t - t0, t_end - t, out))
        k += 1
        if (t_end - t0) + (t_end - t) > seconds:
            return done, t_end - t0
