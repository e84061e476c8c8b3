"""Entry ``solve_stream``: each request is one pass of the whole pool,
in its own order, through ``repro_torch.runtime.BatchSolver.
solve_stream`` (shape and ELL-width buckets, each bucket's lanes stacked,
uploaded and stepped on its own CUDA stream, a CUDA graph a window).
One solver serves every pass, as a server would; the warm-up pass runs
the same buckets through a solver with a budget of a few windows.  A
result the stream does not return is a missing answer."""
from __future__ import annotations

import copy

from perfbench.harness import lp as lpmod


class Entry(lpmod.PoolEntry):

    def generate(self, seed: int) -> None:
        super().generate(seed)
        self.stream = [lpmod.to_program(inst) for inst in self.pool]

    def warm(self) -> None:
        from repro_torch.runtime import BatchSolver

        BatchSolver(self.warm_options(),
                    torch_device=self.device).solve_stream(self.stream)
        self.solver = BatchSolver(self.opts, torch_device=self.device)

    def request(self, k: int) -> lpmod.Served:
        results = list(self.solver.solve_stream(self.stream))
        results += [None] * (len(self.pool) - len(results))
        answers = [lpmod.Answer(i, None, None, 0, "missing") if r is None
                   else lpmod.Answer(i, r.x, r.y, r.iterations, r.status)
                   for i, r in enumerate(results)]
        stats = self.solver.last_stream_stats
        info = {"bucket_windows": copy.deepcopy(stats["bucket_windows"]),
                "check_every": self.opts.check_every,
                "dispatch_s": stats["dispatch_s"],
                "collect_s": stats["collect_s"]}
        return lpmod.Served(answers, info)

    def release(self) -> None:
        self.solver = self.stream = None
