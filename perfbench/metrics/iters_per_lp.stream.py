"""iters_per_lp.stream: as ``iters_per_lp``, for the fixed-rule stream
cell (``BatchItemResult.iterations``)."""
from perfbench.harness import shares


def read(ctx):
    return shares.mean_iterations(ctx)
