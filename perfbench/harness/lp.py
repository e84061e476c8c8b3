"""What the LP entries share: the pool of instances a configuration
names, the solver options, and the answer record the judge and the
metrics read.

The pool is fixed by the configuration and served in its own order:
every run does the same work whatever its seed, so that runs on other
seeds spread no more than two runs on one seed (the dense LPs' steps
to the tolerance range 25200-78400 over generator seeds)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..yardstick import generators

DTYPE_BYTES = {"float64": 8, "float32": 4}


def pool_specs(config: dict) -> List[dict]:
    """The configuration's instances: ``shapes[i % len(shapes)]`` with
    ``seeds[i]``, of ``family`` at ``density``, and where the
    configuration names its instances (``instances``), the name
    ``instances[i % len(instances)]``."""
    shapes = config["shapes"]
    names = config.get("instances")
    return [{"family": config["family"], "m": shapes[i % len(shapes)][0],
             "n": shapes[i % len(shapes)][1],
             "density": config.get("density"), "seed": s,
             "name": names[i % len(names)] if names else None}
            for i, s in enumerate(config["seeds"])]


def make_pool(config: dict) -> List[generators.Instance]:
    return [generators.make(p["family"], p["m"], p["n"], p["seed"],
                            p["density"], p["name"])
            for p in pool_specs(config)]


def options(config: dict, traffic: dict):
    """The program's ``PDHGOptions``: the configuration's solver options
    with the traffic mix's on top."""
    import torch
    from repro_torch.core.pdhg import PDHGOptions

    kw = {**config.get("options", {}), **traffic.get("options", {})}
    kw["dtype"] = getattr(torch, config["dtype"])
    return PDHGOptions(**kw)


def to_program(inst):
    """The program's LP for one of the benchmark's instances."""
    from repro_torch.interop import from_reference_lp

    return from_reference_lp(inst)


class Judged:
    """The judge's readings of LP answers (``reference.judge``), with the
    reference's scaling of one instance at a time kept for the next
    answer to it."""

    def __init__(self, pool, config: dict, device, tol: float):
        self.pool, self.device, self.tol = pool, device, tol
        self.ruiz_iters = config.get("options", {}).get("ruiz_iters", 10)
        self._scaled = (None, None)

    def scaled(self, index: int):
        import torch

        from ..reference import pdhg

        if self._scaled[0] != index:
            self._scaled = (None, None)     # free the last one first
            self._scaled = (index, pdhg.prepare(
                self.pool[index], torch.float64, self.device,
                self.ruiz_iters))
        return self._scaled[1]

    def readings(self, answer) -> dict:
        from ..reference import judge

        inst = self.pool[answer.index]
        out = judge.lp_readings(inst, answer.x, answer.y)
        s = self.scaled(answer.index)
        out["merit"] = judge.scaled_merit(s, inst, answer.x, answer.y)
        if "claim" in answer.extra:
            out["claim"] = judge.claim_gap(s, inst, answer.x, answer.y,
                                           answer.extra["claim"], self.tol)
        return out


@dataclasses.dataclass
class Answer:
    """One LP's answer as the program returned it."""

    index: int                      # position in the pool
    x: Optional[np.ndarray]
    y: Optional[np.ndarray]
    iterations: int
    status: str
    extra: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Served:
    """What one request returned: its answers and what it reported."""

    answers: List[Answer]
    info: dict = dataclasses.field(default_factory=dict)


class PoolEntry:
    """What the entries share: the pool made from the configuration
    (``generate``; the seed changes nothing here, and at most the order
    in which an entry serves the pool), the options, a warm-up
    budget of ``warm_windows`` windows, and the judge's readings of an
    answer.
    An entry adds ``warm``, ``request(k) -> Served`` and ``release``."""

    def __init__(self, config: dict, traffic: dict, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.opts = options(config, traffic)
        self.judged = None

    def generate(self, seed: int) -> None:
        self.pool = make_pool(self.config)

    def warm_options(self):
        return dataclasses.replace(
            self.opts,
            max_iters=self.traffic["warm_windows"] * self.opts.check_every)

    def judge(self) -> Judged:
        if self.judged is None:
            self.judged = Judged(self.pool, self.config, self.device,
                                 self.opts.tol)
        return self.judged

    def readings(self, answer: Answer) -> dict:
        return self.judge().readings(answer)

    def pass_requests(self) -> int:
        """Requests that serve the whole pool once: one, where a request
        is a pass of the pool."""
        return 1

    def reached(self, answer: Answer) -> bool:
        """Whether the answer met the request's goal (the tolerance)."""
        return answer.status == "optimal"
