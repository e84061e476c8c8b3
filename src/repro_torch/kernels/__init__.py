"""Hand-written CUDA kernels of the port, each beside its plain version.

    pdhg_update      B1 dual_update, B2 primal_update (fused updates),
                     and the stepped window's forms of them, dual_step
                     and primal_step, with its schedule
    pdhg_megakernel  B3 fused_dense_steps (two-matrix form) and
                     fused_dense_steps_kt (transpose form), B5
                     fused_ell_steps (one launch per check window)
    sparse_mvm       B4 ell_matvec (row-blocked ELL sparse MVM)
    crossbar_mvm     B6 crossbar_mvm (differential-pair crossbar MVM)

B1-B3 and B5 live in ``csrc/pdhg_kernels.cu``, B4 in
``csrc/sparse_mvm.cu`` and B6 in ``csrc/crossbar_mvm.cu``; the first two
share ``csrc/pdhg_common.cuh``.  All are built on first use into one
library by ``_build`` (nvcc -> shared library -> ctypes), and every one
takes a leading batch axis.  Every wrapper counts its kernel launches;
``reset_launch_counts``/``launch_counts`` let a run show that its main
path went through the kernels.
"""
from . import crossbar_mvm, pdhg_megakernel, pdhg_update, sparse_mvm

WRAPPERS = (pdhg_update.dual_update, pdhg_update.primal_update,
            pdhg_megakernel.fused_dense_steps, sparse_mvm.ell_matvec,
            pdhg_megakernel.fused_ell_steps, crossbar_mvm.crossbar_mvm,
            pdhg_megakernel.fused_dense_steps_kt, pdhg_update.schedule,
            pdhg_update.dual_step, pdhg_update.primal_step)


def launch_counts() -> dict:
    return {f.__name__: f.launches for f in WRAPPERS}


def reset_launch_counts() -> None:
    for f in WRAPPERS:
        f.launches = 0


def add_launch_counts(delta: dict) -> None:
    """Add ``delta`` (wrapper name -> launches) to the counts: a CUDA
    graph's replay launches what its capture counted."""
    for f in WRAPPERS:
        f.launches += delta.get(f.__name__, 0)


__all__ = ["WRAPPERS", "add_launch_counts", "crossbar_mvm", "launch_counts",
           "pdhg_megakernel", "pdhg_update", "reset_launch_counts",
           "sparse_mvm"]
