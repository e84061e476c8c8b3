"""prep_share.stream: the host seconds spent preparing each solve (the
spans ``solve.prepare``: upload, Ruiz scaling, the diagonals; and
``solve.norm``: the operator-norm estimate) over the traced request's
wall time, in %, for the fixed-rule stream cell."""
from perfbench.harness import program_spans


def read(ctx):
    return program_spans.wall_share(ctx, ("solve.prepare", "solve.norm"))
