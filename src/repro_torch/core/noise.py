"""MVM perturbation models (paper §4, Assumptions 1-4); the port of
``repro.core.noise``.

The analog accelerator returns  M v + zeta  where zeta is
  * independent across iterations (Assumption 1),
  * zero-mean / unbiased (Assumption 2),
  * bounded (Assumption 3) with finite variance (Assumption 4).

Two families, as the paper analyzes them:
  multiplicative: w_i * (1 + sigma * g_i)   — conductance C2C/D2D
                  variability scaling with the signal,
  additive:       w + sigma * scale * g     — thermal/electronic read
                  noise independent of the signal.

Gaussians are truncated at ``clip`` std-devs so Assumption 3 (bounded)
holds exactly; truncation at +-c of a symmetric density keeps zero mean.
``apply`` draws from an explicit ``torch.Generator`` on ``w``'s device
where the reference takes a PRNG key.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class NoiseModel:
    kind: str = "none"            # "none" | "multiplicative" | "additive"
    sigma: float = 0.0            # relative noise scale
    clip: float = 4.0             # truncation (std devs) => bounded noise

    def apply(self, generator: torch.Generator, w: torch.Tensor):
        if self.kind == "none" or self.sigma == 0.0:
            return w
        g = torch.randn(w.shape, generator=generator, dtype=w.dtype,
                        device=w.device)
        g = torch.clamp(g, -self.clip, self.clip)
        if self.kind == "multiplicative":
            return w * (1.0 + self.sigma * g)
        if self.kind == "additive":
            # scale to the RMS of the clean product so sigma is relative
            scale = torch.linalg.vector_norm(w) / w.numel() ** 0.5
            return w + self.sigma * scale * g
        raise ValueError(self.kind)

    def bound_delta(self, typical_norm: float = 1.0) -> float:
        """delta of Assumption 3 for step-size safety margins (Lemma 2)."""
        return float(self.sigma * self.clip * typical_norm)


NOISELESS = NoiseModel()


def make_apply(model: NoiseModel) -> Callable:
    return model.apply
