"""iters_per_lp: the mean of each LP's own iterations over the dense
cell's window (``PDHGResult.iterations``)."""
from perfbench.harness import shares


def read(ctx):
    return shares.mean_iterations(ctx)
