"""Distribution runtime of the port on ``torch.distributed``: sharded
PDHG, batched solves, compression, fault tolerance (the port of
``repro.distributed``)."""
from .sharding import (
    axis_size,
    col_axes,
    named_sharding,
    pad_to_multiple,
    padded_dim,
    row_axes,
)
from .pdhg_dist import (
    DistProblem,
    make_dist_step,
    shard_problem,
    solve_dist,
    solve_dist_auto,
)
from .batch_solve import solve_batch, stack_problems
from .fault import (
    CheckpointManager,
    SolverCheckpoint,
    load_checkpoint,
    reshard,
    save_checkpoint,
)
from .compression import compressed_psum, dequantize_int8, quantize_int8

__all__ = [
    "axis_size", "col_axes", "named_sharding", "pad_to_multiple",
    "padded_dim", "row_axes", "DistProblem", "make_dist_step",
    "shard_problem", "solve_dist", "solve_dist_auto", "solve_batch",
    "stack_problems",
    "CheckpointManager", "SolverCheckpoint", "load_checkpoint", "reshard",
    "save_checkpoint", "compressed_psum", "dequantize_int8",
    "quantize_int8",
]
