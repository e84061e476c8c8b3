"""lp_per_s.adaptive: as ``lp_per_s.stream``, for the adaptive step
rule's stream cell."""
from perfbench.harness import shares


def read(ctx):
    return shares.lp_rate(ctx)
