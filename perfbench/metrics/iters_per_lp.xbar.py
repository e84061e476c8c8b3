"""iters_per_lp.xbar: the mean of each LP's own iterations over the
crossbar cell's window (``PDHGResult.iterations``): the budget, where
every answer runs it whole."""
from perfbench.harness import shares


def read(ctx):
    return shares.mean_iterations(ctx)
