"""lp_per_s.xbar: the crossbar cell's LPs that ran their whole iteration
budget (the entry's ``reached``: programming, the norm estimate and the
solve all inside the request), over the wall time of the whole requests
the window held (host data in, host solutions and reports out)."""
from perfbench.harness import shares


def read(ctx):
    return shares.lp_rate(ctx)
