"""The paper's own workload configs: distributed in-memory PDHG LPs (a
copy of ``repro.configs.pdhg_paper``).

Three scales for the dry-run of the paper technique itself (the LM archs
are the assigned pool; THIS is the paper's native workload):

  lp_crossbar : m+n = 256   — exactly the paper's 4x4 x 64x64 logical array
  lp_64k      : K 65,536^2  — one pod, dense f32 tiles (16 GB sharded)
  lp_256k     : K 262,144^2 — multi-pod scale (256 GB of tiles over 512
                chips = 0.5 GB/chip; vectors are KB-scale)

Cells lower ``make_dist_step`` (check_every PDHG iterations between KKT
checks) on the production mesh.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LPConfig:
    name: str
    m: int
    n: int
    n_inner: int = 64          # iterations per lowered step
    dtype: str = "float32"     # iterate vectors
    tile_dtype: str = "float32"  # device-resident K tiles (the "conductances")


LP_CONFIGS = {
    "lp_crossbar": LPConfig("lp_crossbar", m=96, n=160),
    "lp_64k": LPConfig("lp_64k", m=32768, n=32768),
    "lp_256k": LPConfig("lp_256k", m=131072, n=131072),
    # Beyond-paper variant: bf16 tiles — the analogue of conductance
    # quantization, justified by the paper's own Theorem-2 robustness.
    "lp_256k_bf16": LPConfig("lp_256k_bf16", m=131072, n=131072,
                             tile_dtype="bfloat16"),
}
