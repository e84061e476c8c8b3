"""Runtime of the port: meshes, bucketed batch serving, multi-host
serving and the sanitizers; the port of ``repro.runtime``.

  * ``runtime.mesh``     -- one ``make_mesh`` API for every mesh of
    ranks (``torch.distributed`` process groups a tuple of axes).
  * ``runtime.batch``    -- shape-bucketed batch solving of heterogeneous
    LP streams (dense, ELL sparse, COO sparse) with a pipeline cache per
    bucket signature, per-bucket CUDA streams and norm reuse; with a
    mesh, each bucket's lanes split over its ranks.
  * ``runtime.sanitize`` -- cache-miss and kernel-build guard (warm
    streams assert zero) and the transfer guard (CUDA sync debug mode).
  * ``runtime.cluster``  -- multi-host serving: env-driven process-group
    bring-up with a single-process fallback, deterministic per-pod
    bucket routing, and the ``ClusterBatchSolver`` routed-stream
    scheduler.

The reference's ``compat`` only shims JAX versions and has no
counterpart.
"""
from . import batch, mesh, sanitize
# cluster pulls in repro_torch.distributed (its transport), which
# imports this package's batch module: import it last
from . import cluster
from .batch import BatchItemResult, BatchSolver, solve_stream
from .cluster import ClusterBatchSolver, init_cluster
from .sanitize import CompileGuard, RecompileError, no_implicit_transfers
from .mesh import (
    make_cluster_mesh,
    make_local_mesh,
    make_mesh,
    make_production_mesh,
)

__all__ = [
    "BatchItemResult",
    "BatchSolver",
    "ClusterBatchSolver",
    "CompileGuard",
    "RecompileError",
    "batch",
    "cluster",
    "init_cluster",
    "make_cluster_mesh",
    "make_local_mesh",
    "make_mesh",
    "make_production_mesh",
    "mesh",
    "no_implicit_transfers",
    "sanitize",
    "solve_stream",
]
