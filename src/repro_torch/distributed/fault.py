"""Fault tolerance for long-running distributed solves; the port of
``repro.distributed.fault``.

  * snapshot every N iterations to host storage, atomic rename so a crash
    mid-write never corrupts the last good checkpoint;
  * restart is bit-deterministic: PDHG state is (x, x_prev, y, tau,
    sigma, iter) -- restoring it reproduces the exact iterate stream;
  * elastic remesh: checkpoints are stored UNSHARDED (host numpy), so a
    restore can target a different mesh -- re-placement is cutting each
    rank's block from its placement spec (``reshard``);
  * a snapshot is a valid PDHG state, so a failed rank group can be
    dropped and the solve resumed on the survivors without algorithmic
    penalty (PDHG is memoryless beyond one iterate pair).
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from .sharding import Placement, local_block


@dataclasses.dataclass
class SolverCheckpoint:
    step: int
    arrays: Dict[str, np.ndarray]
    meta: Dict[str, Any]


def _host(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, step: int, arrays: Dict[str, Any],
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Atomic snapshot: write to tmp file in the same dir, then rename."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    payload = {k: _host(v) for k, v in arrays.items()}
    payload["__meta__"] = np.frombuffer(
        json.dumps({"step": step, **(meta or {})}).encode(), dtype=np.uint8
    )
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(os.path.abspath(path)) or ".", suffix=".tmp"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)          # atomic on POSIX
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path: str) -> SolverCheckpoint:
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    step = int(meta.pop("step"))
    return SolverCheckpoint(step=step, arrays=arrays, meta=meta)


def reshard(arrays: Dict[str, np.ndarray], mesh,
            specs: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Place host arrays onto a (possibly different) mesh -- elastic
    restore: each rank keeps its block of each array, cut by the array's
    placement spec (a tuple of axes a dimension, or a ``Placement``;
    absent means every rank holds the whole array), on its device."""
    out = {}
    for k, v in arrays.items():
        spec = specs.get(k, ())
        if isinstance(spec, Placement):
            spec = spec.spec
        block = local_block(np.asarray(v), mesh, spec)
        out[k] = torch.as_tensor(np.array(block), device=mesh.device)
    return out


class CheckpointManager:
    """Rotating checkpoint files + crash-consistent latest pointer."""

    def __init__(self, directory: str, keep: int = 3, every: int = 1000):
        self.directory = directory
        self.keep = keep
        self.every = every
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, step: int, arrays: Dict[str, Any],
                   meta: Optional[Dict[str, Any]] = None) -> Optional[str]:
        if step % self.every != 0:
            return None
        path = os.path.join(self.directory, f"ckpt_{step:012d}.npz")
        save_checkpoint(path, step, arrays, meta)
        self._gc()
        return path

    def latest(self) -> Optional[str]:
        files = sorted(
            f for f in os.listdir(self.directory)
            if f.startswith("ckpt_") and f.endswith(".npz")
        )
        return os.path.join(self.directory, files[-1]) if files else None

    def _gc(self):
        files = sorted(
            f for f in os.listdir(self.directory)
            if f.startswith("ckpt_") and f.endswith(".npz")
        )
        for f in files[: -self.keep]:
            os.unlink(os.path.join(self.directory, f))
