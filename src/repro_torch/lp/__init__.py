"""LP substrate of the port: containers and generators, copied from
``repro.lp`` so that the same seed gives byte-identical instances."""
from .problem import INF, LPProblem, SparseCOO, StandardLP, split_standard_solution
from .generators import (
    SPARSE_STREAM_SHAPES,
    TABLE1_SIZES,
    assignment_lp,
    pagerank_lp,
    random_standard_lp,
    sparse_lp_stream,
    sparse_random_standard_lp,
    table1_instance,
)

__all__ = [
    "INF",
    "LPProblem",
    "SparseCOO",
    "StandardLP",
    "split_standard_solution",
    "SPARSE_STREAM_SHAPES",
    "TABLE1_SIZES",
    "assignment_lp",
    "pagerank_lp",
    "random_standard_lp",
    "sparse_lp_stream",
    "sparse_random_standard_lp",
    "table1_instance",
]
