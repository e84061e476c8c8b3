"""stack_share.adaptive: the host seconds the serving layer spends grouping
the stream into buckets, stacking each bucket on the host and uploading
it (the spans ``serve.group``, ``serve.stack`` and ``serve.upload``)
over the traced request's wall time, in %, for the adaptive stream cell."""
from perfbench.harness import program_spans


def read(ctx):
    return program_spans.wall_share(ctx, ("serve.group", "serve.stack", "serve.upload"))
