"""kernel_hbm_share.adaptive: as ``kernel_hbm_share.stream``, for the
adaptive step rule's stream cell."""
from perfbench.harness import shares


def read(ctx):
    return shares.hbm_share(ctx)
