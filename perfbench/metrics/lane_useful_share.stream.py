"""lane_useful_share.stream: the LPs' own iterations over the
lane-iterations the buckets executed (each bucket's lanes times its
windows times the window's steps, from ``BatchSolver.last_stream_stats
["bucket_windows"]`` of every pass), in %, for the fixed-rule stream
cell.  Filler lanes of a padded batch are not counted as lanes."""
from perfbench.harness import shares


def read(ctx):
    return shares.lane_useful_share(ctx)
