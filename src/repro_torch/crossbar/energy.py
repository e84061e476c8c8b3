"""Per-phase energy/latency ledger (shape of paper Tables 4-5); a copy of
``repro.crossbar.energy``.

The ledger accumulates WRITE (programming, once) and READ (per analog MVM)
costs for RRAM backends, and H2D/SOLVE/D2H costs for the GPU baseline.
``snapshot()``/``diff()`` let the benchmark harness split Lanczos-phase vs
PDHG-phase totals exactly like the paper's tables.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Ledger:
    # RRAM phases
    write_energy_j: float = 0.0
    write_latency_s: float = 0.0
    read_energy_j: float = 0.0
    read_latency_s: float = 0.0
    # padding share of the WRITE phase (cells programmed only because the
    # bucket/tile is larger than the logical operator — RESET pulses on
    # all-zero targets).  Already included in ``write_energy_j``; tracked
    # separately so bucketing overhead is auditable.
    write_energy_padding_j: float = 0.0
    # ECC share of the WRITE phase (replicas 1..k-1 of a k-fold
    # differential-pair replication, ``DeviceModel.ecc``).  Included in
    # ``write_energy_j``/``cells_written`` like padding is, and tracked
    # separately so redundancy overhead is auditable per instance.
    write_energy_ecc_j: float = 0.0
    # GPU phases
    h2d_energy_j: float = 0.0
    h2d_latency_s: float = 0.0
    solve_energy_j: float = 0.0
    solve_latency_s: float = 0.0
    d2h_energy_j: float = 0.0
    d2h_latency_s: float = 0.0
    # counters
    mvm_count: int = 0
    cells_written: int = 0
    cells_written_padding: int = 0
    cells_written_ecc: int = 0

    @property
    def write_energy_logical_j(self) -> float:
        return (self.write_energy_j - self.write_energy_padding_j
                - self.write_energy_ecc_j)

    @property
    def total_energy_j(self) -> float:
        return (self.write_energy_j + self.read_energy_j + self.h2d_energy_j
                + self.solve_energy_j + self.d2h_energy_j)

    @property
    def total_latency_s(self) -> float:
        return (self.write_latency_s + self.read_latency_s
                + self.h2d_latency_s + self.solve_latency_s
                + self.d2h_latency_s)

    def snapshot(self) -> "Ledger":
        return dataclasses.replace(self)

    def diff(self, earlier: "Ledger") -> "Ledger":
        out = Ledger()
        for f in dataclasses.fields(Ledger):
            setattr(out, f.name,
                    getattr(self, f.name) - getattr(earlier, f.name))
        return out

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["total_energy_j"] = self.total_energy_j
        d["total_latency_s"] = self.total_latency_s
        d["write_energy_logical_j"] = self.write_energy_logical_j
        return d
