"""Runtime of the port: bucketed batch serving and its sanitizers; the
port of ``repro.runtime`` (ROADMAP A5).

  * ``runtime.batch``    — shape-bucketed batch solving of heterogeneous
    LP streams (dense, ELL sparse, COO sparse) with a pipeline cache per
    bucket signature, per-bucket CUDA streams and norm reuse.
  * ``runtime.sanitize`` — cache-miss and kernel-build guard (warm
    streams assert zero) and the transfer guard (CUDA sync debug mode).

The reference's ``cluster`` and ``mesh`` modules are ROADMAP item A6;
``compat`` only shims JAX versions and has no counterpart.
"""
from . import batch, sanitize
from .batch import BatchItemResult, BatchSolver, solve_stream
from .sanitize import CompileGuard, RecompileError, no_implicit_transfers

__all__ = [
    "BatchItemResult",
    "BatchSolver",
    "CompileGuard",
    "RecompileError",
    "batch",
    "no_implicit_transfers",
    "sanitize",
    "solve_stream",
]
