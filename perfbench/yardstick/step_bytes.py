"""The bytes one PDHG iteration of an LP needs, counted from the LP's
shapes and never from the kernels that run: the operator's stored
entries read once, and the step's vectors read and written once.

The vectors of one iteration (Algorithm 4): the iterate x, the previous
x and the running sum of x for the averaged iterate (n each, read; x and
its sum written), the same for y without a previous copy (m each, read;
y and its sum written), and the problem's c, lb, ub, T (n each) and b,
Sigma (m each), read: 9 n + 6 m values in all.  A dense operator stores
m n values; a sparse one a value and a 4-byte column index a nonzero.
Both products of a step read the same stored entries, so one copy is
counted: a step that reads K twice does twice the least work.
"""
from __future__ import annotations

INDEX_BYTES = 4
VECTORS_N = 9
VECTORS_M = 6


def step_bytes(m: int, n: int, value_bytes: int, nnz=None) -> int:
    """Bytes of one iteration: ``nnz=None`` means a dense operator."""
    if nnz is None:
        entries = m * n * value_bytes
    else:
        entries = nnz * (value_bytes + INDEX_BYTES)
    return entries + (VECTORS_N * n + VECTORS_M * m) * value_bytes
