"""Assigned input shapes (one set, shared by all 10 LM architectures);
the port of ``repro.configs.shapes``.

  train_4k    : seq 4,096  x global_batch 256   -> train_step
  prefill_32k : seq 32,768 x global_batch 32    -> prefill (forward, no grad)
  decode_32k  : seq 32,768 x global_batch 128   -> serve_step (1 new token,
                KV cache of seq_len)
  long_500k   : seq 524,288 x global_batch 1    -> serve_step; ONLY for
                sub-quadratic archs (hymba, rwkv6) — full-attention archs
                skip per the assignment spec.

``input_specs`` returns ``meta`` tensors: shapes and dtypes, nothing
allocated.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models import lm as lm_mod
from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(supported?, reason).  The only skips are long_500k on quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 512k decode cell skipped "
                       "per assignment spec (needs sub-quadratic attention)")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """``meta``-tensor stand-ins for every step input (no allocation).

    [vlm]/[audio] train/prefill cells feed precomputed frontend embeddings
    (the modality frontend is a stub per the assignment); decode cells feed
    token ids of the backbone vocab.
    """
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    tok = meta((B, S), torch.int32)
    if shape.kind == "train":
        if cfg.frontend in ("vision", "audio"):
            return {"embeddings": meta((B, S, cfg.d_model), dt),
                    "labels": tok}
        return {"tokens": tok, "labels": tok}
    if shape.kind == "prefill":
        if cfg.frontend in ("vision", "audio"):
            return {"embeddings": meta((B, S, cfg.d_model), dt)}
        return {"tokens": tok}
    if shape.kind == "decode":
        return {
            "tokens": meta((B, 1), torch.int32),
            "cache": lm_mod.init_cache(cfg, B, S, as_shapes=True),
        }
    raise ValueError(shape.kind)
