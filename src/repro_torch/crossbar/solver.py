"""Crossbar PDHG on the device-resident solve: device physics plus the
analytic energy ledger; the port of ``repro.crossbar.solver``.

  1. Encode M = [[0,K],[K^T,0]] once (quantization + residual
     programming error; the K and K^T blocks are physically distinct
     cells and carry independent error), ledgered as WRITE.
  2. Decode the two programmed blocks K_fwd (≈K) and K_adj (≈K^T) and
     run ``core.pdhg.solve_jit`` on them with per-MVM read noise.
  3. Charge READ energy/latency from the MVM count (2 per PDHG
     iteration + residual checks + Lanczos), with the host path's cost
     constants.

Stream serving is device-tile-aware and batched: ``CrossbarBatchSolver``
(a ``runtime.batch.BatchSolver``) buckets instances to multiples of the
physical crossbar tile, then encodes AND solves each bucket through one
pipeline — programming a stacked (B, R, C) array and solving all B
instances in the batched loop, with ``kernel="cuda"`` every solve MVM a
batched B6 read of the programmed conductances.  Each report's ledger
charges the iterations the batch EXECUTED (the bucket's slowest lane).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .._device import resolve_device
from ..core import engine
from ..core import pdhg as pdhg_mod
from ..core.lanczos import lanczos_svd_jit_mv
from ..core.pdhg import PDHGOptions, PDHGResult
from ..core.residuals import kkt_residuals
from ..core.symblock import build_sym_block
from ..interop import Draws
from ..runtime.batch import (
    BatchSolver,
    BucketPipeline,
    LaneDraws,
    _ceil_to,
    prep_scale,
)
from .device import EPIRAM, DeviceModel
from .encode import EncodedMatrix, charge_write, encode_matrix, encode_stack
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


# ------------------------------------------------- batched stream serving ---

def _array_dims(mb: int, nb: int, device: DeviceModel) -> Tuple[int, int]:
    """Physical array shape of the programmed symmetric block M for a
    (mb, nb) bucket: (mb+nb) rounded up to whole tiles.  With square
    tiles (the shipped devices) this is the identity, but rectangular
    tiles leave (mb+nb) mid-tile in one dimension."""
    d = mb + nb
    return (_ceil_to(d, device.crossbar_rows),
            _ceil_to(d, device.crossbar_cols))


class CrossbarBucketPipeline(BucketPipeline):
    """Prep + encode + solve over a stacked (B, m, n) bucket.

    Per lane: Ruiz/diagonal preconditioning, differential-pair programming
    of M (independent error on the K and K^T blocks; ``encode_stack``),
    Lanczos on the PROGRAMMED operator (or ``opts.norm_override``), then
    the batched loop with the device's read noise.  ``opts.kernel``
    selects the backends: ``"torch"`` decodes the programmed blocks and
    runs the dense operator; ``"cuda"`` keeps the conductance pair on the
    card and issues every solve MVM through B6 (``engine.
    crossbar_operator``) with the update kernels.  The outputs are the
    unscaled ``(x, y, its, merits, rhos, nz)``: ``its`` is (B, rounds +
    1), one column per analog solve, and ``nz`` the per-lane count of
    programmed differential pairs for the write ledger.  With
    ``opts.refine_rounds > 0`` each lane runs the refinement shell
    (``refine.refined_core``) on the same conductances."""

    def __init__(self, opts: PDHGOptions, device: DeviceModel,
                 torch_device=None):
        super().__init__(opts, device.sigma_read, torch_device)
        self.model = device

    def run(self, arrays: list, draws: LaneDraws, rho_seeds=None,
            donate: bool = False, read: Callable = bool):
        from .refine import refined_core   # refine imports solver

        K, b, c, lb, ub = arrays
        (Ks, bs, cs, lbs, ubs, T, Sigma, D1, D2) = prep_scale(
            K, b, c, lb, ub, self.opts)
        if donate:
            arrays[0] = K = None
        B, m, n = Ks.shape
        R, C = _array_dims(m, n, self.model)
        Mp = torch.zeros((B, R, C), dtype=Ks.dtype, device=Ks.device)
        Mp[:, :m + n, :m + n] = build_sym_block(Ks)
        g_pos, g_neg, scale, nz = encode_stack(Mp, self.model, draws.program)
        del Mp
        M_prog = (g_pos - g_neg) * scale[:, None, None]
        K_fwd = M_prog[:, :m, m:m + n].contiguous()
        K_adj = M_prog[:, m:m + n, :m].contiguous()
        del M_prog
        if self.opts.norm_override is not None:
            rho = torch.full((B,), float(self.opts.norm_override),
                             dtype=Ks.dtype, device=Ks.device)
        else:
            # operator norm of the operator actually executed (Lemma 2
            # margin widened for the noisy estimate, as in solve_jit)
            Keff = (torch.sqrt(Sigma)[..., :, None] * K_fwd
                    * torch.sqrt(T)[..., None, :])
            M = build_sym_block(Keff)
            del Keff
            rho = engine.lemma2_margin(lanczos_svd_jit_mv(
                engine.matvec(M), M.shape[-1], M.dtype,
                k_max=self.opts.lanczos_iters, v0=draws.v0,
                device=M.device, batch=B), self.sigma_read)
            del M
        op = None                                # None -> dense decode
        if self.opts.kernel == "cuda":
            op = engine.crossbar_operator(g_pos, g_neg, scale, m, n,
                                          self.sigma_read, draws.noise)
        else:
            del g_pos, g_neg
        x0 = torch.clamp(draws.x0, lbs, ubs)
        # with refine_rounds == 0 the shell is the one analog solve
        x, y, its, merit, windows = yield from refined_core(
            Ks, Ks.transpose(-2, -1), K_fwd, K_adj, bs, cs, lbs, ubs, T,
            Sigma, rho, draws.noise, self.static, x0=x0, y0=draws.y0,
            operator=op, read=read)
        return ((D2 * x, D1 * y, torch.stack(its, dim=-1), merit, rho, nz),
                sum(windows))


def make_crossbar_bucket_pipeline(opts: PDHGOptions, device: DeviceModel,
                                  torch_device=None):
    """Prep + encode + solve over a stacked (B, m, n) bucket (see
    ``CrossbarBucketPipeline``)."""
    return CrossbarBucketPipeline(opts, device, torch_device)


class CrossbarBatchSolver(BatchSolver):
    """Device-tile-aware bucketing scheduler for crossbar-simulated LPs.

    Buckets snap to multiples of ``device.crossbar_rows/cols`` (whole
    physical tiles), each bucket is encoded + solved by one pipeline, and
    the cache key carries the device model, so traffic mixing devices or
    shapes builds at most once per (bucket, batch, device) signature.
    ``solve_stream`` returns ``CrossbarSolveReport`` objects (per-instance
    energy ledger included; residuals in ORIGINAL coordinates).  With
    ``draws=`` each lane's ``Draws.program`` injects its programming
    draw.

    Sparse instances densify on entry (``supports_sparse = False``): a
    crossbar programs every physical cell of its tiles regardless of the
    operator's sparsity.  ``mesh`` splits each bucket's lanes over the
    ranks of ``batch_axes`` (``runtime.batch``).
    """

    supports_sparse = False

    def __init__(self, opts: PDHGOptions = PDHGOptions(), *,
                 device: DeviceModel = EPIRAM, mesh=None,
                 batch_axes: Tuple[str, ...] = ("data",),
                 kernel: Optional[str] = None, async_dispatch: bool = True,
                 transfer_sanitize: bool = False, torch_device=None):
        super().__init__(
            opts, mesh=mesh, batch_axes=batch_axes,
            sigma_read=device.sigma_read,
            tile=(device.crossbar_rows, device.crossbar_cols),
            kernel=kernel, async_dispatch=async_dispatch,
            transfer_sanitize=transfer_sanitize, torch_device=torch_device)
        self.device = device

    def _device_signature(self):
        return self.device           # frozen dataclass -> hashable

    def _make_pipeline(self):
        return make_crossbar_bucket_pipeline(self.opts, self.device,
                                             self.torch_device)

    def _collect(self, out, bucket, idxs, lps, results) -> None:
        xs, ys, its, merits, rhos, nzs = (t.cpu().numpy() for t in out)
        mb, nb = bucket
        R, C = _array_dims(mb, nb, self.device)
        pairs_total = R * C                # tile-padded physical array
        lanczos_mvms = (0 if self.opts.norm_override is not None
                        else self.opts.lanczos_iters)
        # The batched loop executes EVERY lane (filler lanes included)
        # until the slowest lane's check window completes, so the
        # hardware runs — and the ledger charges — the bucket-max
        # iteration count per analog solve.  ``its`` is (B, rounds + 1).
        executed = its.max(axis=0)
        executed_total = int(executed.sum())
        pdhg_mvms = int(sum(
            engine.mvm_accounting(int(e), self.opts.check_every, 0,
                                  restart=self.opts.restart)
            for e in executed))
        digital_mvms = engine.refine_digital_mvms(self.opts.refine_rounds)
        for k, i in enumerate(idxs):
            lp = lps[i]
            m, n = lp.K.shape
            x, y = xs[k, :n], ys[k, :m]
            it = int(its[k].sum())
            merit = float(merits[k])
            ledger = Ledger()
            fill = charge_write(ledger, self.device, float(nzs[k]),
                                pairs_logical=(m + n) ** 2,
                                pairs_total=pairs_total)
            active_cells = (2.0 * pairs_total * fill
                            * max(1, self.device.ecc))
            _charge_reads(ledger, self.device, lanczos_mvms + pdhg_mvms,
                          active_cells)
            t = {f: torch.as_tensor(np.asarray(v, np.float64))
                 for f, v in (("x", x), ("y", y), ("c", lp.c), ("b", lp.b),
                              ("Kx", lp.K @ x), ("KTy", lp.K.T @ y),
                              ("lb", lp.lb), ("ub", lp.ub))}
            res = kkt_residuals(t["x"], t["x"], t["y"], t["c"], t["b"],
                                t["Kx"], t["KTy"], lb=t["lb"], ub=t["ub"])
            if not np.isfinite(merit):
                status = "diverged"     # NaN merit: blow-up, not a limit
            elif merit <= self.opts.tol:
                status = "optimal"
            else:
                status = "iteration_limit"
            result = PDHGResult(
                status=status,
                x=x, y=y, obj=float(lp.c @ x), iterations=it,
                residuals=res, sigma_max=float(rhos[k]),
                lanczos_iters=lanczos_mvms,
                mvm_calls=lanczos_mvms + pdhg_mvms,
                merit=merit,
            )
            results[i] = CrossbarSolveReport(
                result=result, ledger=ledger, device=self.device,
                lanczos_mvms=lanczos_mvms, pdhg_mvms=pdhg_mvms,
                executed_iterations=executed_total,
                digital_mvms=digital_mvms,
            )


def solve_crossbar_stream(
    lps: Sequence,
    opts: PDHGOptions = PDHGOptions(),
    device: DeviceModel = EPIRAM,
    *,
    mesh=None,
    solver: Optional[CrossbarBatchSolver] = None,
    torch_device=None,
    draws: Optional[Callable] = None,
) -> List[CrossbarSolveReport]:
    """Serve a heterogeneous LP stream on one simulated crossbar tier.

    Instances bucket to whole physical tiles and every bucket runs
    encode -> solve as one pipeline (see ``CrossbarBatchSolver``) on
    ``torch_device`` (the card unless it says otherwise).  Pass
    ``solver`` to keep the pipelines warm across streams, ``draws`` to
    inject every lane's draws; ``mesh`` shards each bucket's lanes over
    its ranks (``runtime.batch``)."""
    if solver is None:
        solver = CrossbarBatchSolver(opts, device=device, mesh=mesh,
                                     torch_device=torch_device)
    return solver.solve_stream(lps, draws=draws)
