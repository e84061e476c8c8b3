"""A crossbar tier rebuilt from the device's documented model, in plain
PyTorch (float64), for the judge of the crossbar cells.

The model (arXiv 2509.21137, section 3.1; MELISO+): an LP's Ruiz-scaled
K is stored once as the symmetric block M = [[0, K], [K^T, 0]], padded
with zeros to whole tiles of ``crossbar_rows`` x ``crossbar_cols``, as
a differential pair M ~ s (G+ - G-) with s = max|M|:

* quantization: Q+ = round((max(M, 0) / s) (L - 1)) / (L - 1), and Q-
  alike from max(-M, 0), for L = ``g_levels`` conductance levels;
* programming error: G = clip(Q (1 + sigma_program z), 0, 1), each cell
  with its own standard normal z, drawn from one generator seeded with
  the configuration's programming seed on the device the tier is
  programmed on: first the whole padded array of G+'s draws, then that
  of G-'s;
* the programmed K and K^T are the blocks [:m, m:m+n] and [m:m+n, :m]
  of s (G+ - G-): distinct cells, with errors of their own.

Reads (one analog MVM a product) add a multiplicative error of relative
std ``sigma_read`` to each output; the judge does not rebuild them.

``ledger`` derives what a solve of ``iterations`` steps costs on the
device from the shapes, the quantized array and the device's constants:
a norm estimate of ``lanczos`` MVMs, two MVMs a step and four a check;
two cells a tile-padded pair written once; write-verify pulses for
every pair with a nonzero target and one reset pulse for each other
cell; read energy for each cell with a nonzero target on every MVM.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class Tier:
    """The programmed blocks of one LP and what the ledger reads."""

    K_fwd: torch.Tensor          # programmed K (m x n)
    K_adj: torch.Tensor          # programmed K^T (n x m), its own cells
    rows: int                    # padded array, whole tiles
    cols: int
    logical: int                 # m + n
    nonzero_pairs: int           # pairs whose quantized target is nonzero


def _ceil_to(v: int, k: int) -> int:
    return -(-v // k) * k


def program(Ks: torch.Tensor, device: dict, seed: int, *,
            quantize: bool = True, program_error: bool = True) -> Tier:
    """Program the scaled K on the tier ``device`` (the configuration's
    ``device`` block).  ``quantize`` and ``program_error`` off leave that
    step out (what a tier without it would hold)."""
    m, n = Ks.shape
    d = m + n
    R = _ceil_to(d, int(device["crossbar_rows"]))
    C = _ceil_to(d, int(device["crossbar_cols"]))
    W = torch.zeros((R, C), dtype=Ks.dtype, device=Ks.device)
    W[:m, m:d] = Ks
    W[m:d, :m] = Ks.T
    raw = torch.max(torch.abs(W))
    s = float(raw) if float(raw) > 0 else 1.0
    top = int(device["g_levels"]) - 1

    def target(part):
        g = part / s
        return torch.round(g * top) / top if quantize else g

    q_pos = target(torch.clamp(W, min=0.0))
    q_neg = target(torch.clamp(-W, min=0.0))
    del W
    nonzero = int(torch.count_nonzero((q_pos > 0) | (q_neg > 0)))
    gen = torch.Generator(device=Ks.device).manual_seed(int(seed))
    sigma = float(device["sigma_program"])

    def programmed(q):
        if not program_error:
            return q
        z = torch.randn((R, C), generator=gen, dtype=Ks.dtype,
                        device=Ks.device)
        return torch.clamp(q * (1.0 + sigma * z), 0.0, 1.0)

    g_pos = programmed(q_pos)
    del q_pos
    g_neg = programmed(q_neg)
    del q_neg
    M = (g_pos - g_neg) * s
    del g_pos, g_neg
    return Tier(M[:m, m:d].contiguous(), M[m:d, :m].contiguous(), R, C, d,
                nonzero)


def ledger(tier: Tier, device: dict, iterations: int, check_every: int,
           lanczos: int) -> dict:
    """The counters and the modelled energies and latencies of one solve
    of ``iterations`` steps on ``tier`` (field names as the program's
    report)."""
    checks = max(1, iterations // max(1, check_every))
    pdhg = 2 * iterations + 4 * checks
    mvms = lanczos + pdhg
    pairs = tier.rows * tier.cols
    pad_pairs = pairs - tier.logical ** 2
    nz = tier.nonzero_pairs
    pulses_logical = (2 * nz * device["avg_write_pulses"]
                      + 2 * (tier.logical ** 2 - nz))
    pulses_padding = 2 * pad_pairs
    e_pulse = device["write_pulse_energy_j"]
    fill = nz / pairs
    tile_cells = 2 * device["crossbar_rows"] * device["crossbar_cols"]
    return {
        "lanczos_mvms": lanczos,
        "pdhg_mvms": pdhg,
        "mvm_count": mvms,
        "cells_written": 2 * pairs,
        "cells_written_padding": 2 * pad_pairs,
        "cells_written_ecc": 0,
        "write_energy_j": (pulses_logical + pulses_padding) * e_pulse,
        "write_energy_padding_j": pulses_padding * e_pulse,
        "write_energy_ecc_j": 0.0,
        "write_latency_s": (tile_cells
                            * (fill * device["avg_write_pulses"]
                               + (1.0 - fill))
                            * device["write_pulse_latency_s"]),
        "read_energy_j": (mvms * 2 * nz
                          * device["read_energy_per_cell_j"]),
        "read_latency_s": mvms * device["read_latency_s"],
    }


COUNTS = ("lanczos_mvms", "pdhg_mvms", "mvm_count", "cells_written",
          "cells_written_padding", "cells_written_ecc")


def ledger_gaps(reported: dict, derived: dict) -> tuple:
    """``(counts, model)``: the largest absolute gap of a counter, and
    the largest relative gap of a modelled energy or latency (absolute
    where the derived value is 0), between the report and the
    derivation.  A field missing from the report reads inf."""
    counts = model = 0.0
    for k, want in derived.items():
        got = reported.get(k)
        if got is None:
            return float("inf"), float("inf")
        gap = abs(float(got) - float(want))
        if k in COUNTS:
            counts = max(counts, gap)
        else:
            model = max(model, gap / abs(want) if want else gap)
    return counts, model


def tier_readings(s, tiers: dict, inst, x, sigma_read: float) -> dict:
    """``noise`` and ``tier`` of an answer's ``x`` to ``inst`` (original
    coordinates), in the scaled frame of ``s`` (``pdhg.prepare`` of the
    instance), against ``tiers``: the answer's own (``"prog"``) and those
    that lack one step of the programming.

    * ``noise``: sigma_read ||K x|| / ||K' x - b|| with K the exact scaled
      K and K' the answer's tier;
    * ``tier``: the largest over the other tiers K'' of -<r, d> / <d, d>,
      with r = K' x - b and d = (K'' - K') x, and ``tier_<name>`` each.

    inf for a missing, misshapen or non-finite answer, and ``tier`` inf
    where another tier does not move K' x."""
    names = [k for k in tiers if k != "prog"]
    bad = {"noise": math.inf, "tier": math.inf,
           **{f"tier_{k}": math.inf for k in names}}
    n = inst.shape[1]
    if x is None:
        return bad
    x = np.asarray(x, np.float64).reshape(-1)
    if x.shape != (n,) or not np.all(np.isfinite(x)):
        return bad
    xt = torch.as_tensor(x, device=s.b.device) / s.d2
    norm = torch.linalg.vector_norm
    own = tiers["prog"].K_fwd @ xt
    r = own - s.b
    rn = float(norm(r))
    out = {"noise": (sigma_read * float(norm(s.op.mv(xt))) / rn
                     if rn > 0 else math.inf)}
    for k in names:
        d = tiers[k].K_fwd @ xt - own
        dd = float(torch.dot(d, d))
        out[f"tier_{k}"] = (-float(torch.dot(r, d)) / dd if dd > 0
                            else math.inf)
    out["tier"] = max(out[f"tier_{k}"] for k in names)
    return out
