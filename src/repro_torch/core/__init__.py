# The paper's primary contribution, ported: enhanced PDHG for LPs on the
# dense single-instance path (``solve_jit``) and the host driver
# (``solve``) over encoded accelerator handles.
from . import engine
from .engine import (
    Operator,
    PDHGState,
    Updates,
    accel_operator,
    crossbar_operator,
    dense_operator,
    make_updates,
    mvm_accounting,
    pdhg_loop,
    pdhg_step,
    sharded_operator,
)
from .symblock import (
    MODE_AX,
    MODE_ATY,
    MODE_FULL,
    Accel,
    as_dense,
    build_sym_block,
    encode_exact,
    encode_noisy,
    matmul_accel,
    scaled_accel,
)
from .lanczos import (
    NORM_BACKENDS,
    LanczosResult,
    lanczos_svd,
    lanczos_svd_jit,
    lanczos_svd_jit_mv,
    power_iteration,
    power_iteration_mv,
)
from .noise import NOISELESS, NoiseModel
from .precondition import (
    ScaledProblem,
    apply_ruiz,
    diagonal_precondition,
    ruiz_rescale,
)
from .residuals import KKTResiduals, kkt_residuals, relative_error
from .theory import (
    SafeCoupling,
    lemma2_worst_case,
    safe_coupling,
    spectral_ratio,
    theorem1_envelope,
    theorem2_envelope,
)
from .pdhg import PDHGOptions, PDHGResult, prepare, solve, solve_jit
from .infeasibility import Certificate, check_farkas, difference_ray

__all__ = [
    "engine", "Operator", "PDHGState", "Updates", "accel_operator",
    "crossbar_operator", "dense_operator", "make_updates", "mvm_accounting",
    "pdhg_loop", "pdhg_step", "sharded_operator", "MODE_AX", "MODE_ATY",
    "MODE_FULL", "Accel",
    "as_dense", "build_sym_block", "encode_exact", "encode_noisy",
    "matmul_accel", "scaled_accel", "NORM_BACKENDS", "LanczosResult",
    "lanczos_svd", "lanczos_svd_jit", "lanczos_svd_jit_mv", "power_iteration",
    "power_iteration_mv", "NOISELESS", "NoiseModel", "ScaledProblem",
    "apply_ruiz", "diagonal_precondition", "ruiz_rescale", "KKTResiduals",
    "kkt_residuals", "relative_error", "SafeCoupling", "lemma2_worst_case",
    "safe_coupling", "spectral_ratio", "theorem1_envelope",
    "theorem2_envelope", "PDHGOptions", "PDHGResult", "prepare", "solve",
    "solve_jit", "Certificate", "check_farkas", "difference_ray",
]
