"""MELISO+-style crossbar device simulation; the port of
``repro.crossbar``."""
from .device import DEVICES, EPIRAM, TAOX_HFOX, DeviceModel
from .encode import (
    EncodedMatrix,
    charge_write,
    encode_core,
    encode_matrix,
    encode_stack,
    write_verify_error,
)
from .energy import Ledger
from .array import CrossbarArray, analog_linear, crossbar_accel_factory
from .gpu import RTX6000, GPUModel
from .refine import refined_core, solve_crossbar_refined
from .solver import (
    CrossbarBatchSolver,
    CrossbarSolveReport,
    make_crossbar_bucket_pipeline,
    solve_crossbar_jit,
    solve_crossbar_stream,
)

__all__ = [
    "DEVICES", "EPIRAM", "TAOX_HFOX", "DeviceModel",
    "EncodedMatrix", "charge_write", "encode_core", "encode_matrix",
    "encode_stack", "write_verify_error",
    "Ledger", "CrossbarArray", "analog_linear", "crossbar_accel_factory",
    "RTX6000", "GPUModel", "CrossbarBatchSolver", "CrossbarSolveReport",
    "make_crossbar_bucket_pipeline", "refined_core",
    "solve_crossbar_jit", "solve_crossbar_refined", "solve_crossbar_stream",
]
