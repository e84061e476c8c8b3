"""check_share.dense: the device seconds of the loop's checks (the span
``loop.check``: the residual check, the restart and the step rule) over
those of its windows and checks (``loop.window`` + ``loop.check``), each
from CUDA events on the stream that ran it, in %, for the dense cell."""
from perfbench.harness import program_spans


def read(ctx):
    return program_spans.check_share(ctx)
