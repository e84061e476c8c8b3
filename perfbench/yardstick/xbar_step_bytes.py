"""The bytes one PDHG iteration on a crossbar tier needs, counted from the
LP's shapes and never from the kernels that run: both programmed blocks
read once, and the step's vectors read and written once.

The programmed K and K^T are distinct cells with errors of their own
(``reference.crossbar``), so a step's forward product reads the m x n
block of K and its adjoint the n x m block of K^T: 2 m n values, where a
digital step needs one copy of K (``step_bytes``).  The vectors are
those of ``step_bytes``: 9 n + 6 m values.  At 3840 x 7680 in f64 that
is 472.6 MB, or 0.1411 ms at 3.35 TB/s.
"""
from __future__ import annotations

from .step_bytes import VECTORS_M, VECTORS_N


def step_bytes(m: int, n: int, value_bytes: int) -> int:
    """Bytes of one iteration on the decoded blocks of a crossbar tier."""
    return (2 * m * n + VECTORS_N * n + VECTORS_M * m) * value_bytes
