"""Conductance encoding with write-verify (paper §3.1 + ref [40]); the
port of ``repro.crossbar.encode``.

RRAM conductances are non-negative, so a real matrix W is stored as a
differential pair  W ~ s * (G+ - G-)  with
    G+ = quantize(max(W, 0) / s),   G- = quantize(max(-W, 0) / s),
where s scales max|W| onto the device's usable conductance range
(normalized conductance units g in [0, 1] with ``g_levels`` steps).
Write-verify leaves a zero-mean Gaussian residual error of relative std
``sigma_program``; the expected pulse count per cell drives the
programming energy/latency ledger.

  * ``encode_core``    — the device-physics map (quantize + programming
                         error + ECC replicas and fault masks); draws
                         from an explicit ``torch.Generator``, or takes
                         the programming-error draw injected.
  * ``encode_matrix``  — single-matrix wrapper: tile padding,
                         ``EncodedMatrix`` handle, ledger side effects.

The write ledger depends only on the count of nonzero QUANTIZED targets,
so it is exact whatever the programming noise.  At full width (M of
11520² in f64 is 1.06 GB) the encode works in place where the reference
builds new arrays, and frees each temporary as soon as it is used.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .device import DeviceModel
from .energy import Ledger


@dataclasses.dataclass
class EncodedMatrix:
    g_pos: torch.Tensor     # (R, C) normalized conductances in [0, 1]
    g_neg: torch.Tensor
    scale: float            # W ~ scale * (g_pos - g_neg)
    rows: int               # logical (unpadded) shape
    cols: int
    device: DeviceModel
    fill: float = 1.0       # fraction of programmed (nonzero) cells —
                            # zero-conductance cells draw ~no read current

    def decode(self) -> torch.Tensor:
        return (self.g_pos - self.g_neg)[: self.rows, : self.cols] * self.scale

    @property
    def active_cells(self) -> float:
        # every ECC replica's cells draw read current on every MVM
        return (2.0 * self.g_pos.shape[0] * self.g_pos.shape[1] * self.fill
                * max(1, self.device.ecc))


def _quantize_(g: torch.Tensor, levels: int) -> torch.Tensor:
    """``round(g * (levels - 1)) / (levels - 1)``, in place."""
    return g.mul_(levels - 1).round_().div_(levels - 1)


ECC_DECODES = ("median", "mean")


def ecc_decode(stack: torch.Tensor, how: str) -> torch.Tensor:
    """Reduce a (k, ...) replica stack per cell.  ``"median"`` sorts the
    replica axis and, for an even k, averages the middle pair as
    ``jnp.median``/``numpy.median`` do (``torch.median`` would return the
    lower one, and ``torch.quantile`` refuses inputs above 2**24
    elements)."""
    if how == "mean":
        return torch.mean(stack, dim=0)
    k = stack.shape[0]
    s = torch.sort(stack, dim=0).values
    if k % 2:
        return s[k // 2]
    return (s[k // 2 - 1] + s[k // 2]) / 2


def encode_core(W: torch.Tensor, generator: Optional[torch.Generator],
                g_levels: int, sigma_program: float, *, ecc: int = 1,
                ecc_decode_how: str = "median", stuck_rate: float = 0.0,
                drift: float = 0.0,
                program_draw: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None):
    """Differential-pair programming model.

    ``W`` must already be padded to its physical array shape.  Returns
    ``(g_pos, g_neg, scale, nz)`` with ``scale`` and ``nz`` (the number
    of nonzero-QUANTIZED-target pairs) as 0-d tensors; ``g_pos``/
    ``g_neg`` are the decoded effective conductances: with ``ecc = k >
    1`` each cell is programmed onto k replicas (independent error and
    faults per replica) and reduced per cell by ``ecc_decode_how``.

    Random draws come from ``generator`` (on ``W``'s device).
    ``program_draw = (z_pos, z_neg)`` injects the two standard-normal
    programming-error arrays of the fault-free single-copy path instead,
    so that a test can hand in the reference's draws.
    """
    if ecc_decode_how not in ECC_DECODES:
        raise ValueError(f"unknown ecc_decode {ecc_decode_how!r}; expected "
                         f"one of {ECC_DECODES}")
    if ecc < 1:
        raise ValueError(f"ecc replication factor must be >= 1 (got {ecc})")
    fault_free = ecc == 1 and stuck_rate == 0.0 and drift == 0.0
    if program_draw is not None and not fault_free:
        raise ValueError("an injected programming draw covers the "
                         "fault-free single-copy path only (ecc=1, no "
                         "stuck cells, no drift)")
    raw = torch.max(torch.abs(W))
    scale = torch.where(raw > 0, raw, torch.ones_like(raw))
    g_pos_q = _quantize_(torch.clamp(W, min=0.0).div_(scale), g_levels)
    g_neg_q = _quantize_(torch.neg(W).clamp_(min=0.0).div_(scale), g_levels)
    nz = torch.sum((g_pos_q > 0) | (g_neg_q > 0))

    def normal():
        return torch.randn(W.shape, generator=generator, dtype=W.dtype,
                           device=W.device)

    def program(g_q, z):
        """One array of one replica: ``clip(g_q * (1 + sigma * z), 0,
        1)``, with ``z`` consumed in place."""
        return z.mul_(sigma_program).add_(1.0).mul_(g_q).clamp_(0.0, 1.0)

    def stuck(g):
        """Stuck-at faults replace the programmed value (half stuck-OFF
        at 0, half stuck-ON at 1)."""
        mask = torch.rand(W.shape, generator=generator, dtype=W.dtype,
                          device=W.device) < stuck_rate
        on = torch.rand(W.shape, generator=generator, dtype=W.dtype,
                        device=W.device) < 0.5
        return torch.where(mask, on.to(W.dtype), g)

    def replica():
        gp, gn = program(g_pos_q, normal()), program(g_neg_q, normal())
        if stuck_rate > 0.0:
            gp, gn = stuck(gp), stuck(gn)
        if drift > 0.0:
            # drift decays whatever is stored, faulted or not
            gp, gn = gp.mul_(1.0 - drift), gn.mul_(1.0 - drift)
        return gp, gn

    if fault_free:
        z_pos, z_neg = ((normal(), normal()) if program_draw is None else
                        (torch.as_tensor(z, dtype=W.dtype,
                                         device=W.device).clone()
                         for z in program_draw))
        g_pos = program(g_pos_q, z_pos)
        del g_pos_q
        g_neg = program(g_neg_q, z_neg)
    elif ecc == 1:
        g_pos, g_neg = replica()
    else:
        reps = [replica() for _ in range(ecc)]
        g_pos = ecc_decode(torch.stack([r[0] for r in reps]), ecc_decode_how)
        g_neg = ecc_decode(torch.stack([r[1] for r in reps]), ecc_decode_how)
    return g_pos, g_neg, scale, nz


def charge_write(ledger: Ledger, device: DeviceModel, nz: float,
                 pairs_logical: int, pairs_total: int) -> float:
    """Accumulate the programming cost of one differential array.

    ``nz`` nonzero-target pairs consume the full write-verify pulse train
    (2 cells each); zero-target pairs take one RESET pulse per cell.
    Pairs outside the logical region (tile padding, always zero-target)
    are additionally ledgered under the ``*_padding`` fields.  With
    ``device.ecc = k > 1`` the whole array (padding included) is
    programmed k times; replicas 1..k-1 are additionally ledgered under
    the ``*_ecc`` fields.  Returns the fill fraction (for read-energy
    accounting)."""
    nz = float(nz)
    replicas = max(1, device.ecc)
    tr, tc = device.crossbar_rows, device.crossbar_cols
    fill = nz / pairs_total
    pulses_logical = (nz * 2 * device.avg_write_pulses
                      + (2 * pairs_logical - 2 * nz) * 1.0)
    pulses_padding = 2.0 * (pairs_total - pairs_logical)
    pulses_one = pulses_logical + pulses_padding
    ledger.write_energy_j += (replicas * pulses_one
                              * device.write_pulse_energy_j)
    ledger.write_energy_padding_j += (pulses_padding
                                      * device.write_pulse_energy_j)
    ledger.write_energy_ecc_j += ((replicas - 1) * pulses_one
                                  * device.write_pulse_energy_j)
    # tiles program in parallel (ECC replicas are parallel tile sets, so
    # latency is ecc-independent); within a tile, cells are row-serial:
    # nonzero-target cells take the full write-verify train, zero-target
    # cells one RESET pulse each
    cells_per_tile = tr * tc * 2
    pulses_serial = cells_per_tile * (
        fill * device.avg_write_pulses + (1.0 - fill) * 1.0)
    ledger.write_latency_s += pulses_serial * device.write_pulse_latency_s
    ledger.cells_written += replicas * 2 * pairs_total
    ledger.cells_written_padding += 2 * (pairs_total - pairs_logical)
    ledger.cells_written_ecc += (replicas - 1) * 2 * pairs_total
    return fill


def encode_matrix(
    W: torch.Tensor,
    device: DeviceModel,
    generator: Optional[torch.Generator] = None,
    ledger: Optional[Ledger] = None,
    pad_to_tiles: bool = True,
    program_draw=None,
) -> EncodedMatrix:
    """Program W onto (padded) crossbar tiles with write-verify.  Draws
    come from ``generator`` (default: seeded with 0 on ``W``'s device);
    ``program_draw`` is passed to ``encode_core``."""
    rows, cols = W.shape
    tr, tc = device.crossbar_rows, device.crossbar_cols
    if generator is None:
        generator = torch.Generator(device=W.device).manual_seed(0)
    if pad_to_tiles:
        R = -(-rows // tr) * tr
        C = -(-cols // tc) * tc
    else:
        R, C = rows, cols
    if (R, C) != (rows, cols):
        Wp = torch.zeros((R, C), dtype=W.dtype, device=W.device)
        Wp[:rows, :cols] = W
    else:
        Wp = W
    g_pos, g_neg, scale, nz = encode_core(
        Wp, generator, device.g_levels, device.sigma_program,
        ecc=device.ecc, ecc_decode_how=device.ecc_decode,
        stuck_rate=device.stuck_rate, drift=device.drift,
        program_draw=program_draw)
    del Wp
    nz = float(nz)
    fill = nz / (R * C)
    if ledger is not None:
        fill = charge_write(ledger, device, nz,
                            pairs_logical=rows * cols, pairs_total=R * C)
    return EncodedMatrix(
        g_pos=g_pos, g_neg=g_neg, scale=float(scale), rows=rows, cols=cols,
        device=device, fill=fill,
    )


def write_verify_error(enc: EncodedMatrix, W: torch.Tensor) -> float:
    """Max relative deviation between programmed and target matrix."""
    err = torch.abs(enc.decode() - W)
    return float(torch.max(err) / (torch.max(torch.abs(W)) + 1e-30))
