"""lp_per_s: the dense cell's LPs that reached the tolerance, over the
wall time of the whole requests the window held (host data in, host
solutions out)."""
from perfbench.harness import shares


def read(ctx):
    return shares.lp_rate(ctx)
