"""Entry ``solve_jit``: each request is one pass of the pool: each LP
solved in turn to the tolerance by ``repro_torch.core.pdhg.solve_jit``
with the configuration's options (on a card, each window of a dense K
whose rows suit it as B3's transpose form, one launch that reads K once
a step; cuBLAS products only in the check), host data in and host
solution out; each answer carries the residuals the solve reports for
it."""
from __future__ import annotations

import time

from perfbench.harness import lp as lpmod


class Entry(lpmod.PoolEntry):

    def generate(self, seed: int) -> None:
        super().generate(seed)
        self.lps = [lpmod.to_program(inst) for inst in self.pool]

    def warm(self) -> None:
        from repro_torch.core.pdhg import solve_jit

        solve_jit(self.lps[0], self.warm_options(), device=self.device)

    def request(self, k: int) -> lpmod.Served:
        from repro_torch.core.pdhg import solve_jit

        answers = []
        for i, lp in enumerate(self.lps):
            t = time.perf_counter()
            res = solve_jit(lp, self.opts, device=self.device)
            r = res.residuals
            answers.append(lpmod.Answer(
                i, res.x, res.y, res.iterations, res.status,
                {"wall_s": time.perf_counter() - t,
                 "claim": {"r_pri": float(r.r_pri),
                           "r_dual": float(r.r_dual),
                           "r_gap": float(r.r_gap)}}))
        return lpmod.Served(answers)

    def release(self) -> None:
        self.lps = None
