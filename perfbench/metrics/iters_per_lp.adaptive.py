"""iters_per_lp.adaptive: as ``iters_per_lp.stream``, for the adaptive
step rule's stream cell."""
from perfbench.harness import shares


def read(ctx):
    return shares.mean_iterations(ctx)
