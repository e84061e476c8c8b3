"""RRAM device models (MELISO+/NeuroSim+-style constants); a copy of
``repro.crossbar.device``.

Two technologies from the paper:
  * EpiRAM        — Choi et al., Nature Materials 17, 335 (2018) [ref 57]:
                    SiGe epitaxial RRAM; fast, low-energy analog READ but
                    relatively expensive write-verify programming.
  * TaOx-HfOx     — Wu et al., VLSI 2018 [ref 58]: engineered bilayer with
                    high programming linearity => far fewer verify pulses,
                    much lower write voltage/duration (the paper attributes
                    its consistently superior energy numbers to exactly
                    this), at slightly slower integrate+ADC read.

Constants below are calibrated so the end-to-end ledger reproduces the
ORDER OF MAGNITUDE of the paper's Tables 4-5 (per-phase energy/latency and
the 10x-5000x improvement factors over the GPU baseline); the simulation
runs on no physical RRAM, so exact joules are not reproducible — the
improvement-factor structure is the reproduction target.

Noise parameters feed the solver's robustness machinery (§4): residual
programming error after write-verify (device-to-device) and cycle-to-cycle
read noise, both relative/multiplicative and unbiased (Assumption 2).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    name: str
    # --- geometry -----------------------------------------------------
    crossbar_rows: int = 64          # physical tile size (paper: 64x64)
    crossbar_cols: int = 64
    grid_rows: int = 4               # 4x4 array of tiles (paper) => 256x256
    grid_cols: int = 4
    # --- conductance programming --------------------------------------
    g_levels: int = 256              # distinguishable conductance levels
    avg_write_pulses: float = 30.0   # mean write-verify pulses per cell
    write_pulse_energy_j: float = 3.0e-6
    write_pulse_latency_s: float = 5.0e-6
    sigma_program: float = 2.0e-3    # residual relative error after verify
    # --- analog read (one MVM per tile, tiles fire in parallel) --------
    read_energy_per_cell_j: float = 2.1e-8   # V^2 * g * t_int + ADC share
    read_latency_s: float = 2.2e-5           # DAC + integrate + ADC
    sigma_read: float = 1.0e-3       # cycle-to-cycle multiplicative
    # --- converters (None = ideal; set to int bits to model quantization)
    dac_bits: int | None = None
    adc_bits: int | None = None
    # --- error correction / fault tolerance (arXiv 2508.13298) ----------
    # ``ecc`` programs k physically distinct replicas of every
    # differential pair on k parallel tile sets; reads decode the replica
    # stack per cell (``ecc_decode``: "median" is robust to a minority of
    # stuck replicas, "mean" averages programming noise down by sqrt(k)).
    # Replicas 1..k-1 are ledgered under the ``*_ecc`` fields, and every
    # replica cell draws read current on every MVM (k-fold read energy).
    ecc: int = 1                     # replication factor (1 = off)
    ecc_decode: str = "median"       # "median" | "mean"
    stuck_rate: float = 0.0          # per-cell stuck-at fault probability
    #                                  (half stuck-OFF g=0, half stuck-ON g=1)
    drift: float = 0.0               # relative conductance decay mask
    #                                  applied after programming (retention)

    @property
    def logical_rows(self) -> int:
        return self.crossbar_rows * self.grid_rows

    @property
    def logical_cols(self) -> int:
        return self.crossbar_cols * self.grid_cols


# Calibration notes (back-solved from paper Tables 4-5, gen-ip002):
#   EpiRAM  write: 0.75 J / (65*65*2 diff cells) ~ 8.9e-5 J/cell
#           at ~30 pulses/cell  => ~3e-6 J/pulse; tile-parallel latency
#           0.33 s => ~5e-6 s/pulse.
#   EpiRAM  read:  ~1.8e-4 J per logical MVM => ~2.1e-8 J/cell;
#           ~2.2e-5 s per MVM.
EPIRAM = DeviceModel(
    name="EpiRAM",
    avg_write_pulses=30.0,
    write_pulse_energy_j=3.0e-6,
    write_pulse_latency_s=5.0e-6,
    sigma_program=2.0e-3,
    read_energy_per_cell_j=2.1e-8,
    read_latency_s=2.2e-5,
    sigma_read=1.0e-3,
)

#   TaOx-HfOx write: 0.0114 J / 8450 cells ~ 1.35e-6 J/cell at ~8
#           pulses/cell => ~1.7e-7 J/pulse; latency 0.039 s => ~2.3e-6 s.
#   TaOx-HfOx read: ~8e-5 J per MVM => ~9.5e-9 J/cell; ~4.6e-5 s per MVM
#           (slower integrate+ADC, but far cheaper writes — the paper's
#           "physics of the device" advantage).
TAOX_HFOX = DeviceModel(
    name="TaOx-HfOx",
    avg_write_pulses=8.0,
    write_pulse_energy_j=1.7e-7,
    write_pulse_latency_s=2.3e-6,
    sigma_program=1.0e-3,
    read_energy_per_cell_j=9.5e-9,
    read_latency_s=4.6e-5,
    sigma_read=5.0e-4,
)

DEVICES = {d.name: d for d in (EPIRAM, TAOX_HFOX)}
