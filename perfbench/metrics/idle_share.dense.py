"""idle_share.dense: the share of a request's wall time with no
operation on the card: one minus the traced request's device-busy time
(the union of its device intervals) over the mean wall time of the
window's untraced requests, which do the same work, in %."""
from perfbench.harness import shares


def read(ctx):
    return shares.idle_share(ctx)
