"""idle_share.adaptive: as ``idle_share.dense``, for the adaptive step
rule's stream cell."""
from perfbench.harness import shares


def read(ctx):
    return shares.idle_share(ctx)
