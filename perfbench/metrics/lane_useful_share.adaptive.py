"""lane_useful_share.adaptive: as ``lane_useful_share.stream``, for
the adaptive step rule's stream cell."""
from perfbench.harness import shares


def read(ctx):
    return shares.lane_useful_share(ctx)
