"""The H100's published peaks and the bound arithmetic, frozen from
``chip_smoke.py`` (NVIDIA's data sheet, SXM part, dense rates: HBM3 at
3.35 TB/s; 67 TFLOP/s in FP64 on the tensor cores and in FP32 outside
them)."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 67e12, "float32": 67e12}


def bound_s(bytes_moved: float, ops: float, dtype: str):
    """The least time the chip needs: the larger of the bytes over HBM's
    rate and the operations over the peak rate.  Returns ``(seconds,
    "bytes" | "operations")``."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
