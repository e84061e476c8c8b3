"""idle_share.stream: as ``idle_share.dense``, for the fixed-rule stream
cell's traced pass."""
from perfbench.harness import shares


def read(ctx):
    return shares.idle_share(ctx)
