"""Crossbar PDHG on the device-resident solve: device physics plus the
analytic energy ledger; the port of ``repro.crossbar.solver``'s single
instance path (the batched stream belongs to the batch slice).

  1. Encode M = [[0,K],[K^T,0]] once (quantization + residual
     programming error; the K and K^T blocks are physically distinct
     cells and carry independent error), ledgered as WRITE.
  2. Decode the two programmed blocks K_fwd (≈K) and K_adj (≈K^T) and
     run ``core.pdhg.solve_jit`` on them with per-MVM read noise.
  3. Charge READ energy/latency from the MVM count (2 per PDHG
     iteration + residual checks + Lanczos), with the host path's cost
     constants.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .._device import resolve_device
from ..core import pdhg as pdhg_mod
from ..core.pdhg import PDHGOptions, PDHGResult
from ..core.symblock import build_sym_block
from ..interop import Draws
from .device import EPIRAM, DeviceModel
from .encode import EncodedMatrix, encode_matrix
from .energy import Ledger


@dataclasses.dataclass
class CrossbarSolveReport:
    result: PDHGResult
    ledger: Ledger
    device: DeviceModel
    lanczos_mvms: int
    pdhg_mvms: int
    # iterations the hardware executed (and the ledger charged); with
    # refinement, the sum over every round
    executed_iterations: int = 0
    # exact residual MVMs of the digital refinement shell
    # (``engine.refine_digital_mvms``), deliberately NOT charged to the
    # analog read ledger
    digital_mvms: int = 0


def _charge_reads(ledger: Ledger, device: DeviceModel, n_mvms: int,
                  active_cells: float):
    ledger.read_energy_j += (n_mvms * active_cells
                             * device.read_energy_per_cell_j)
    ledger.read_latency_s += n_mvms * device.read_latency_s
    ledger.mvm_count += n_mvms


def program_blocks(lp, opts: PDHGOptions, device: DeviceModel, seed: int,
                   ledger: Ledger, torch_device, program_draw=None):
    """Ruiz-scale on the card (Algorithm 4 step 0), program M once, and
    decode it.  Returns ``(scaled, T, Sigma, K_fwd, K_adj,
    active_cells)``; the conductances themselves are freed."""
    scaled, T, Sigma = pdhg_mod.prepare(lp, opts, torch_device)
    m, _ = scaled.K.shape
    gen = torch.Generator(device=torch_device).manual_seed(seed)
    enc: EncodedMatrix = encode_matrix(build_sym_block(scaled.K), device,
                                       gen, ledger=ledger,
                                       program_draw=program_draw)
    active_cells = enc.active_cells
    M_prog = enc.decode()
    del enc
    K_fwd = M_prog[:m, m:].contiguous()      # programmed K block
    K_adj = M_prog[m:, :m].contiguous()      # programmed K^T (distinct cells)
    del M_prog
    return scaled, T, Sigma, K_fwd, K_adj, active_cells


def solve_crossbar_jit(
    lp,
    opts: PDHGOptions = PDHGOptions(),
    device: DeviceModel = EPIRAM,
    seed: Optional[int] = None,
    ledger: Optional[Ledger] = None,
    *,
    torch_device=None,
    program_draw=None,
    draws: Optional[Draws] = None,
) -> CrossbarSolveReport:
    """Encode once, then the device-resident solve on the programmed
    blocks.  ``device`` is the crossbar model; the hardware is
    ``torch_device`` (``cuda`` unless it says otherwise).  ``seed``
    seeds the programming draws (default ``opts.seed``);
    ``program_draw`` injects them (see ``encode.encode_core``) and
    ``draws`` the solve's start vectors (see ``interop.Draws``).
    With ``opts.refine_rounds > 0`` the refinement shell runs instead.
    """
    if opts.refine_rounds > 0:
        # digital iterative-refinement shell: same encode-once contract,
        # extra analog read windows per round, zero extra writes
        from . import refine as refine_mod
        return refine_mod.solve_crossbar_refined(
            lp, opts, device, seed, ledger, torch_device=torch_device,
            program_draw=program_draw, draws=draws)
    dev = resolve_device(torch_device)
    pdhg_mod.opts_static(opts, device.sigma_read)
    seed = opts.seed if seed is None else seed
    ledger = ledger if ledger is not None else Ledger()
    _, _, _, K_fwd, K_adj, active_cells = program_blocks(
        lp, opts, device, seed, ledger, dev, program_draw)
    result = pdhg_mod.solve_jit(lp, opts, K_fwd=K_fwd, K_adj=K_adj,
                                sigma_read=device.sigma_read, device=dev,
                                draws=draws)
    # READ accounting: ``result.mvm_calls`` already counts Lanczos
    # (``result.lanczos_iters``) + PDHG (2/iter) + residual checks (4 per
    # check) — charge it wholesale
    lanczos_mvms = result.lanczos_iters
    pdhg_mvms = result.mvm_calls - lanczos_mvms
    _charge_reads(ledger, device, result.mvm_calls, active_cells)
    return CrossbarSolveReport(
        result=result, ledger=ledger, device=device,
        lanczos_mvms=lanczos_mvms, pdhg_mvms=pdhg_mvms,
        executed_iterations=result.iterations,
    )
