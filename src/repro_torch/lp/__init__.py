"""LP substrate of the port: containers and generators, copied from
``repro.lp`` so that the same seed gives byte-identical instances."""
from .problem import INF, LPProblem, SparseCOO, StandardLP, split_standard_solution
from .generators import (
    TABLE1_SIZES,
    assignment_lp,
    crossbar_sized_lp,
    infeasible_lp,
    netlib_like,
    pagerank_lp,
    random_inequality_lp,
    random_inequality_lp_known,
    random_standard_lp,
    sparse_lp_stream,
    sparse_random_standard_lp,
    SPARSE_STREAM_SHAPES,
    table1_instance,
)

__all__ = [
    "INF",
    "LPProblem",
    "SparseCOO",
    "StandardLP",
    "split_standard_solution",
    "TABLE1_SIZES",
    "assignment_lp",
    "crossbar_sized_lp",
    "infeasible_lp",
    "netlib_like",
    "pagerank_lp",
    "random_inequality_lp",
    "random_inequality_lp_known",
    "random_standard_lp",
    "sparse_lp_stream",
    "sparse_random_standard_lp",
    "SPARSE_STREAM_SHAPES",
    "table1_instance",
]
