"""kernel_hbm_share.stream: as ``kernel_hbm_share.dense``, for the
fixed-rule stream cell's traced pass (a sparse operator's stored
entries)."""
from perfbench.harness import shares


def read(ctx):
    return shares.hbm_share(ctx)
