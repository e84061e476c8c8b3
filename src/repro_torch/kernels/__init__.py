"""Hand-written CUDA kernels of the port, each beside its plain version.

    pdhg_update      B1 dual_update, B2 primal_update (fused updates)
    pdhg_megakernel  B3 fused_dense_steps (one launch per check window)
    crossbar_mvm     B6 crossbar_mvm (differential-pair crossbar MVM)

B1-B3 live in ``csrc/pdhg_kernels.cu`` and B6 in ``csrc/crossbar_mvm.cu``,
built on first use into one library by ``_build`` (nvcc -> shared
library -> ctypes).  Every wrapper counts its kernel launches;
``reset_launch_counts``/``launch_counts`` let a run show that its main
path went through the kernels.
"""
from . import crossbar_mvm, pdhg_megakernel, pdhg_update

WRAPPERS = (pdhg_update.dual_update, pdhg_update.primal_update,
            pdhg_megakernel.fused_dense_steps, crossbar_mvm.crossbar_mvm)


def launch_counts() -> dict:
    return {f.__name__: f.launches for f in WRAPPERS}


def reset_launch_counts() -> None:
    for f in WRAPPERS:
        f.launches = 0


__all__ = ["WRAPPERS", "crossbar_mvm", "launch_counts", "pdhg_megakernel",
           "pdhg_update", "reset_launch_counts"]
