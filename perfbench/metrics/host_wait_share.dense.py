"""host_wait_share.dense: the host seconds blocked in the loop's one host
read a window (the span ``loop.read``) over the traced request's wall
time, in %: high when the host runs ahead of the card, for the dense
cell."""
from perfbench.harness import program_spans


def read(ctx):
    return program_spans.wall_share(ctx, ("loop.read",))
