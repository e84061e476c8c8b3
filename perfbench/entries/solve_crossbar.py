"""Entry ``solve_crossbar``: each request is one LP of the pool, taken in
an order drawn from the run's seed (every seed the same pool, in another
order): the LP programmed afresh onto the configuration's crossbar tier
and solved for its whole iteration budget by ``repro_torch.crossbar.
solver.solve_crossbar_jit`` (Ruiz scaling, the symmetric block M programmed as
a differential pair, K and K^T decoded from their own cells, the norm
estimate on the programmed operator, then the eager stepped windows with
read noise on every product), host data in and host solution and
report out.  The device model is the program's of the name the
configuration's ``device`` block gives; the block holds the numbers the
judge needs.

Each answer carries the residuals the solve reports (``claim``) and the
report's ledger with its MVM counts (``ledger``).  Besides the LP
judge's readings, the judge reads (``reference.crossbar``):

* ``budget``: how far the answer's iterations fall short of the budget
  (an answer that stopped for any other reason than the budget reads
  inf): every answer runs its whole budget;
* ``noise``: sigma_read ||K x|| over the answer's primal residual
  ||K' x - b|| on its own tier K' (the programmed K the reference
  rebuilds), in the scaled frame: the read noise holds the answer on a
  floor whose residual is a steady share of sigma_read ||K x||, so that
  an answer read through less noise, or none, lies nearer its tier and
  reads higher;
* ``tier``: for each of the two tiers that lack one step of the
  programming (no programming error; no quantization), the share of the
  step from the answer's tier to that one along which the answer's
  primal residual lies, -<K' x - b, d> / <d, d> with d = (K'' - K') x,
  the larger of the two: near 0 for an answer solved on its tier as
  the model programs it, near 1 for one solved on the other;
* ``ledger``, ``ledger_model``: the largest gap of a counter, and the
  largest relative gap of a modelled energy or latency, between the
  report and what the reference derives from the shapes, the iterations
  and the device block.
"""
from __future__ import annotations

import math
import time

import numpy as np

from perfbench.harness import lp as lpmod
from perfbench.reference import crossbar as xref

TIERS = {"prog": {}, "no_program_error": {"program_error": False},
         "no_quantization": {"quantize": False}}


class Entry(lpmod.PoolEntry):

    def __init__(self, config: dict, traffic: dict, device):
        super().__init__(config, traffic, device)
        self.block = config["device"]
        self._tiers = (None, None)

    def model(self):
        from repro_torch.crossbar.device import DEVICES

        return DEVICES[self.block["name"]]

    def generate(self, seed: int) -> None:
        super().generate(seed)
        self.lps = [lpmod.to_program(inst) for inst in self.pool]
        self.order = np.random.default_rng(seed).permutation(len(self.lps))

    def warm(self) -> None:
        """Every LP of the pool (each its own shapes) for a few windows."""
        from repro_torch.crossbar.solver import solve_crossbar_jit

        for lp in self.lps:
            solve_crossbar_jit(lp, self.warm_options(), self.model(),
                               torch_device=self.device)

    def pass_requests(self) -> int:
        """Requests that serve the whole pool once."""
        return len(self.lps)

    def request(self, k: int) -> lpmod.Served:
        from repro_torch.crossbar.solver import solve_crossbar_jit

        i = int(self.order[k % len(self.lps)])
        t = time.perf_counter()
        rep = solve_crossbar_jit(self.lps[i], self.opts, self.model(),
                                 torch_device=self.device)
        res = rep.result
        r = res.residuals
        ledger = rep.ledger.as_dict()
        ledger.update(lanczos_mvms=rep.lanczos_mvms,
                      pdhg_mvms=rep.pdhg_mvms)
        return lpmod.Served([lpmod.Answer(
            i, res.x, res.y, res.iterations, res.status,
            {"wall_s": time.perf_counter() - t,
             "claim": {"r_pri": float(r.r_pri), "r_dual": float(r.r_dual),
                       "r_gap": float(r.r_gap)},
             "ledger": ledger})])

    def release(self) -> None:
        self.lps = None

    def reached(self, answer: lpmod.Answer) -> bool:
        """Whether the answer ran its whole budget."""
        return (answer.status == "iteration_limit"
                and answer.iterations == self.opts.max_iters)

    def tiers(self, index: int) -> dict:
        """The rebuilt tiers of one instance, kept for the next answer to
        it."""
        if self._tiers[0] != index:
            self._tiers = (None, None)      # free the last ones first
            Ks = self.judge().scaled(index).op.K
            self._tiers = (index, {
                k: xref.program(Ks, self.block, self.opts.seed, **kw)
                for k, kw in TIERS.items()})
        return self._tiers[1]

    def readings(self, answer: lpmod.Answer) -> dict:
        out = self.judge().readings(answer)
        out["budget"] = (abs(self.opts.max_iters - answer.iterations)
                         if answer.status == "iteration_limit"
                         else math.inf)
        s = self.judge().scaled(answer.index)
        inst = self.pool[answer.index]
        out.update(xref.tier_readings(s, self.tiers(answer.index), inst,
                                      answer.x,
                                      float(self.block["sigma_read"])))
        derived = xref.ledger(self.tiers(answer.index)["prog"], self.block,
                              answer.iterations, self.opts.check_every,
                              self.opts.lanczos_iters)
        out["ledger"], out["ledger_model"] = xref.ledger_gaps(
            answer.extra.get("ledger", {}), derived)
        return out
