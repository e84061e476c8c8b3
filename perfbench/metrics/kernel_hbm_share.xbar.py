"""kernel_hbm_share.xbar: the least time the traced request's crossbar
steps need at HBM's rate (both programmed blocks and the step's vectors
once a step, see ``yardstick.xbar_step_bytes``), over the device-busy
time of the trace, in %."""
from perfbench.harness import lp
from perfbench.yardstick import peaks, xbar_step_bytes


def read(ctx):
    if ctx.trace is None or ctx.trace["busy_s"] <= 0:
        return None
    size = lp.DTYPE_BYTES[ctx.cell.config["dtype"]]
    least = sum(a.iterations * xbar_step_bytes.step_bytes(
                    *ctx.entry.pool[a.index].shape, size)
                for a in ctx.traced.out.answers) / peaks.HBM_BYTES_PER_S
    return 100.0 * least / ctx.trace["busy_s"]
