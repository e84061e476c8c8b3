"""lp_per_s.stream: as ``lp_per_s``, for the fixed-rule stream cell: LPs
of the window's whole passes that reached the tolerance, over their
wall time."""
from perfbench.harness import shares


def read(ctx):
    return shares.lp_rate(ctx)
