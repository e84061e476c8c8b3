"""MELISO+-style crossbar device simulation; the port of
``repro.crossbar`` (the batched crossbar stream belongs to the batch
slice)."""
from .device import DEVICES, EPIRAM, TAOX_HFOX, DeviceModel
from .encode import (
    EncodedMatrix,
    charge_write,
    ecc_decode,
    encode_core,
    encode_matrix,
    write_verify_error,
)
from .energy import Ledger
from .array import CrossbarArray, analog_linear, crossbar_accel_factory
from .gpu import RTX6000, GPUModel
from .refine import refined_core, solve_crossbar_refined
from .solver import CrossbarSolveReport, solve_crossbar_jit

__all__ = [
    "DEVICES", "EPIRAM", "TAOX_HFOX", "DeviceModel",
    "EncodedMatrix", "charge_write", "ecc_decode", "encode_core",
    "encode_matrix", "write_verify_error",
    "Ledger", "CrossbarArray", "analog_linear", "crossbar_accel_factory",
    "RTX6000", "GPUModel", "CrossbarSolveReport", "refined_core",
    "solve_crossbar_jit", "solve_crossbar_refined",
]
