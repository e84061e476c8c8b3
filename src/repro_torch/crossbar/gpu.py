"""Analytic GPU cost model — the paper's gpuPDLP baseline (a copy of
``repro.crossbar.gpu``).

The paper measured a single NVIDIA Quadro RTX6000 (Zeus framework) on the
OSU Pete cluster.  The baseline is an analytic model with RTX6000-class
constants; it models that card, not the one the port runs on, and
nothing here is measured.  The model is deliberately
simple and *favourable* to the GPU on large shapes (bandwidth-bound matmul
with a fixed per-iteration overhead); on the paper's small LPs the fixed
overhead dominates — exactly the regime where Tables 2-5 show the GPU
losing by 10^2-10^3 in energy.

Calibration (paper Table 5, gen-ip002: 834 J / 69.2 s over 2331 PDHG
iterations => ~29.7 ms and ~0.36 J per iteration on a (24,41) LP):
  * per-iteration fixed latency ~ 1.4e-2 s  (kernel launches, host sync,
    residual checks; PDLP-style implementations issue dozens of small
    kernels per iteration at these sizes)
  * active power draw ~ 60 W of a 260 W TDP card at tiny occupancy, plus
    idle draw folded in.
"""
from __future__ import annotations

import dataclasses

from .energy import Ledger

PCIE_BW = 12.0e9           # B/s effective host<->device
PCIE_EJ_PER_BYTE = 2.0e-8  # J/B transfer energy
H2D_FIXED_S = 5.0e-2       # cudaMalloc/stream setup per problem
H2D_FIXED_J = 2.2          # measured-by-Zeus style setup energy
GPU_FLOPS = 16.3e12        # RTX6000 fp32 peak
GPU_HBM_BW = 672.0e9       # B/s GDDR6
GPU_POWER_ACTIVE_W = 60.0  # small-kernel occupancy regime
ITER_FIXED_S = 1.4e-2      # per-PDHG-iteration launch+sync overhead
MVM_FIXED_S = 2.6e-3       # per standalone MVM (Lanczos) overhead


@dataclasses.dataclass
class GPUModel:
    name: str = "gpuPDLP"

    def h2d(self, nbytes: int, ledger: Ledger):
        t = H2D_FIXED_S + nbytes / PCIE_BW
        ledger.h2d_latency_s += t
        ledger.h2d_energy_j += H2D_FIXED_J + nbytes * PCIE_EJ_PER_BYTE

    def d2h(self, nbytes: int, ledger: Ledger):
        t = nbytes / PCIE_BW
        ledger.d2h_latency_s += t
        ledger.d2h_energy_j += 0.01 + nbytes * PCIE_EJ_PER_BYTE

    def _mvm_time(self, m: int, n: int) -> float:
        flops = 2.0 * m * n
        nbytes = 4.0 * (m * n + m + n)
        return max(flops / GPU_FLOPS, nbytes / GPU_HBM_BW)

    def pdhg_iteration(self, m: int, n: int, ledger: Ledger):
        """Two MVMs + ~10 vector kernels + host residual sync."""
        t = ITER_FIXED_S + 2 * self._mvm_time(m, n)
        ledger.solve_latency_s += t
        ledger.solve_energy_j += t * GPU_POWER_ACTIVE_W / 2.45
        ledger.mvm_count += 2

    def lanczos_iteration(self, dim: int, ledger: Ledger):
        t = MVM_FIXED_S + self._mvm_time(dim, dim)
        ledger.solve_latency_s += t
        ledger.solve_energy_j += t * GPU_POWER_ACTIVE_W / 2.2
        ledger.mvm_count += 1


RTX6000 = GPUModel()
