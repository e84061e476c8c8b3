"""Row-blocked ELL sparse MVM: CUDA kernel B4, its plain version, and
the host-side COO->ELL conversion.

    data (m, W) float   row i's nonzero values, zero-padded to width W
    cols (m, W) int32   matching column indices (padding points at 0)

so one MVM is a gather and a row reduction with no scatter anywhere,

    w[i] = sum_j data[i, j] * v[cols[i, j]]

Padding entries carry data == 0, so whatever ``cols`` says for them
(index 0 by convention) contributes nothing: the inertness contract of
the COO stacking's (0, 0) padding.  ``ell_row_len`` gives each row's
length up to its last slot that is not such (0, 0) padding; with it the
MVM reads no slot past that length and adds one ``0 * v[0]`` term in
their place (the same value, NaN included, as multiplying them all).

The port of ``repro/kernels/sparse_mvm.py``: the numpy host helpers
(``ell_width_bucket``, ``coo_row_widths``, ``ell_from_coo``,
``ROW_BLOCK``, ``MIN_ELL_WIDTH``) are copied as they are; ``ell_matvec``
is B4, the port of ``_ell_kernel`` (``ell_matvec_kernel`` in
``csrc/sparse_mvm.cu``, which also says what bounds it on the H100), and
``ell_matvec_plain`` the counterpart of ``ell_matvec_ref``.

Both take an optional leading batch axis: ``data``/``cols`` (B, m, W)
with ``v`` (B, n) and row lengths (B, m), one launch for every lane.
``ell_matvec`` launches the kernel for CUDA tensors and takes the plain
version for CPU tensors, and only for them; width 0 returns zeros
without a launch.  It counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from .pdhg_update import _on_cpu

# Row-block edge: matches crossbar_mvm.TILE_R so ELL row blocks and
# crossbar tiles describe the same physical row partitioning.
ROW_BLOCK = 128
# Smallest ELL width bucket (power-of-two bucketing, like nnz_bucket).
MIN_ELL_WIDTH = 4


# ------------------------------------------------------ host conversion ---

def ell_width_bucket(width: int, min_size: int = MIN_ELL_WIDTH) -> int:
    """Round an ELL width up to its power-of-two bucket so repeat sparse
    traffic with drifting row occupancy reuses compiled executables
    (the ELL twin of ``runtime.batch.nnz_bucket``)."""
    return max(min_size, 1 << (max(int(width), 1) - 1).bit_length())


def coo_row_widths(row, col, data, shape: Tuple[int, int]) -> Tuple[int, int]:
    """(max nonzeros per row, max nonzeros per column) of a COO triplet,
    counting only true nonzeros — explicit zeros (nnz padding at (0, 0)
    included) never widen the ELL form."""
    data = np.asarray(data).reshape(-1)
    keep = data != 0
    row = np.asarray(row).reshape(-1)[keep]
    col = np.asarray(col).reshape(-1)[keep]
    m, n = shape
    wf = int(np.bincount(row, minlength=max(m, 1)).max()) if m else 0
    wa = int(np.bincount(col, minlength=max(n, 1)).max()) if n else 0
    return wf, wa


def ell_from_coo(data, row, col, shape: Tuple[int, int],
                 width: Optional[int] = None):
    """Host-side COO -> ELL conversion (numpy).

    Drops explicit zero entries first (they carry no information and
    would only widen rows), then packs each row's nonzeros
    left-justified in column-sorted order.  Returns ``(ell_data (m, W),
    ell_cols (m, W) int32)`` with ``W = width`` (must cover the widest
    row) or the exact max row width when ``width`` is None.  Rows with
    no nonzeros — including every row of an all-zero K — come back fully
    padded (data 0, cols 0), which the matvec treats as inert.
    """
    m, n = int(shape[0]), int(shape[1])
    data = np.asarray(data).reshape(-1)
    keep = data != 0
    data = data[keep]
    row = np.asarray(row, np.int64).reshape(-1)[keep]
    col = np.asarray(col, np.int64).reshape(-1)[keep]
    order = np.lexsort((col, row))
    data, row, col = data[order], row[order], col[order]
    counts = np.bincount(row, minlength=max(m, 1))[:max(m, 1)]
    w_need = int(counts.max()) if m else 0
    W = w_need if width is None else int(width)
    assert W >= w_need, (W, w_need)
    ell_data = np.zeros((m, W), data.dtype)
    ell_cols = np.zeros((m, W), np.int32)
    if data.size:
        # position of each entry within its row (entries are row-sorted)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        pos = np.arange(data.size) - np.repeat(starts, counts)
        ell_data[row, pos] = data
        ell_cols[row, pos] = col
    return ell_data, ell_cols


# ------------------------------------------------------------ the MVM ---

def lane_index(cols: torch.Tensor, n: int) -> torch.Tensor:
    """int64 indices into the flattened (B * n) vectors of a batch: each
    lane's columns shifted by ``lane * n`` (``cols`` itself when there is
    no batch axis)."""
    idx = cols.long()
    if cols.dim() == 3:
        lanes = torch.arange(cols.shape[0], device=cols.device)
        idx = idx + (lanes * n).view(-1, 1, 1)
    return idx


def ell_row_len(data: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """int32 (..., m): 1 + the index of each row's last slot that is not
    (0, 0) padding (a nonzero value or a nonzero column), 0 for an empty
    row.  One tensor op on the forms' device; nothing is read on the
    host.  Every slot past it is padding, so the MVM may skip it."""
    W = data.shape[-1]
    if W == 0:
        return torch.zeros(data.shape[:-1], dtype=torch.int32,
                           device=data.device)
    stored = (data != 0) | (cols != 0)
    pos = torch.arange(1, W + 1, dtype=torch.int32, device=data.device)
    return torch.amax(stored * pos, dim=-1).to(torch.int32)


def ell_matvec_plain(data, cols, v, row_len=None):
    """Plain PyTorch version of B4 (the kernel's oracle): one gather and
    one row sum, accumulated in the input type; every slot is
    multiplied, and with ``row_len`` the slots from it on are read as
    (0, 0) padding."""
    if data.shape[-1] == 0:
        return torch.zeros(data.shape[:-1], dtype=v.dtype, device=v.device)
    if row_len is not None:
        pos = torch.arange(data.shape[-1], device=data.device)
        keep = pos < row_len.unsqueeze(-1)
        data = torch.where(keep, data, torch.zeros((), dtype=data.dtype,
                                                   device=data.device))
        cols = torch.where(keep, cols, torch.zeros((), dtype=cols.dtype,
                                                   device=cols.device))
    index = lane_index(cols, v.shape[-1])
    return torch.sum(data * v.reshape(-1)[index], dim=-1)


def check_ell(data: torch.Tensor, cols: torch.Tensor, row_len=None):
    """``(rows, W)`` of an ELL pair on the card: float values, int32
    columns of the same (m, W) or (B, m, W) shape, both contiguous, and
    optionally int32 row lengths of shape (m,) or (B, m)."""
    if data.dim() not in (2, 3) or tuple(cols.shape) != tuple(data.shape):
        raise ValueError(f"data and cols must be one (m, W) or (B, m, W) "
                         f"shape, got {tuple(data.shape)} and "
                         f"{tuple(cols.shape)}")
    if cols.dtype != torch.int32:
        raise TypeError(f"ELL columns are int32, got {cols.dtype}")
    if cols.device != data.device or not cols.is_contiguous():
        raise ValueError("ELL columns must be contiguous, on the values' "
                         "device")
    _build.check_cuda_operands(data)
    check_row_len(data, row_len)
    return data.shape[-2], data.shape[-1]


def check_row_len(data: torch.Tensor, row_len) -> None:
    """Row lengths, when given, are contiguous int32 of shape
    ``data.shape[:-1]`` on the values' device."""
    if row_len is not None and (
            tuple(row_len.shape) != tuple(data.shape[:-1])
            or row_len.dtype != torch.int32
            or row_len.device != data.device
            or not row_len.is_contiguous()):
        raise ValueError(f"row lengths must be contiguous int32 of shape "
                         f"{tuple(data.shape[:-1])} on {data.device}, got "
                         f"{row_len.dtype} {tuple(row_len.shape)} on "
                         f"{row_len.device}")


def ell_matvec(data, cols, v, row_len=None):
    """B4: ``w[..., i] = sum_j data[..., i, j] * v[..., cols[..., i, j]]``.

    ``data``/``cols`` (m, W) with ``v`` (n,), or (B, m, W) with (B, n);
    ``v`` may be a strided slice whose last axis is contiguous (a part
    of a longer vector).  ``row_len`` ((m,) or (B, m) int32, from
    ``ell_row_len``) lets the kernel stop each row at its last stored
    slot; None walks all W.  Every column index must lie in [0, n): the
    kernel does not check it (``runtime.batch.stack_problems_ell``
    checks the COO it converts).  Returns a new contiguous (m,) or
    (B, m)."""
    if v.dim() != data.dim() - 1 or (data.dim() == 3
                                     and v.shape[0] != data.shape[0]):
        raise ValueError(f"v must be (n,) against (m, W) or (B, n) against "
                         f"(B, m, W); got {tuple(v.shape)} against "
                         f"{tuple(data.shape)}")
    check_row_len(data, row_len)
    if _on_cpu(data):
        return ell_matvec_plain(data, cols, v, row_len)
    m, W = check_ell(data, cols)
    B = data.shape[0] if data.dim() == 3 else 1
    if v.stride(-1) != 1:
        v = v.contiguous()
    if v.dtype != data.dtype or v.device != data.device:
        raise TypeError(f"v must be {data.dtype} on {data.device}, got "
                        f"{v.dtype} on {v.device}")
    out = torch.empty(data.shape[:-1], dtype=data.dtype, device=data.device)
    if W == 0:
        return out.zero_()
    _build.launch("ell_matvec", data.dtype, data.data_ptr(),
                  cols.data_ptr(), _build.pointer(row_len), v.data_ptr(),
                  out.data_ptr(), m, W, B,
                  m * W, v.stride(0) if v.dim() == 2 else 0, m)
    ell_matvec.launches += 1
    return out


ell_matvec.launches = 0
