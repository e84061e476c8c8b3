"""kernel_hbm_share.dense: the least time the traced request's PDHG
steps need at HBM's rate (one copy of the operator a step, see
``yardstick.step_bytes``), over the device-busy time of the trace, in
%."""
from perfbench.harness import shares


def read(ctx):
    return shares.hbm_share(ctx)
