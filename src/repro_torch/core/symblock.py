"""Symmetric block-matrix formulation (paper Algorithm 1); the port of
``repro.core.symblock`` as far as the dense solve needs it.

    M = [[0_{m x m}, K       ],
         [K^T,       0_{n x n}]]

Every MVM the solver needs is one MVM against M with mode-dependent
zero padding / slicing (the ``MODE_*`` names).  The ``Accel`` handles
of the host loop (``repro.core.pdhg.solve``) belong to the crossbar
slice.
"""
from __future__ import annotations

import torch

MODE_FULL = "full"
MODE_AX = "A@x"
MODE_ATY = "AT@y"


def build_sym_block(K) -> torch.Tensor:
    """Algorithm 1 (BUILDSYMBLOCK), host step: M from K (m x n)."""
    m, n = K.shape
    M = torch.zeros((m + n, m + n), dtype=K.dtype, device=K.device)
    M[:m, m:] = K
    M[m:, :m] = K.T
    return M
