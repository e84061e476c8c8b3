# The paper's primary contribution, ported: enhanced PDHG for LPs on the
# dense single-instance path (``solve_jit``).
from . import engine
from .engine import (
    Operator,
    PDHGState,
    Updates,
    dense_operator,
    make_updates,
    mvm_accounting,
    pdhg_loop,
    pdhg_step,
)
from .symblock import MODE_AX, MODE_ATY, MODE_FULL, build_sym_block
from .lanczos import (
    NORM_BACKENDS,
    lanczos_svd_jit,
    lanczos_svd_jit_mv,
    power_iteration_mv,
)
from .precondition import (
    ScaledProblem,
    apply_ruiz,
    diagonal_precondition,
    ruiz_rescale,
)
from .residuals import KKTResiduals, kkt_residuals, relative_error
from .pdhg import PDHGOptions, PDHGResult, prepare, solve_jit

__all__ = [
    "engine", "Operator", "PDHGState", "Updates", "dense_operator",
    "make_updates", "mvm_accounting", "pdhg_loop", "pdhg_step",
    "MODE_AX", "MODE_ATY", "MODE_FULL", "build_sym_block",
    "NORM_BACKENDS", "lanczos_svd_jit", "lanczos_svd_jit_mv",
    "power_iteration_mv", "ScaledProblem", "apply_ruiz",
    "diagonal_precondition", "ruiz_rescale", "KKTResiduals",
    "kkt_residuals", "relative_error", "PDHGOptions", "PDHGResult",
    "prepare", "solve_jit",
]
