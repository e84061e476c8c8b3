"""granite-3-8b [dense] — 40L d=4096 32H (GQA kv=8) ff=12800 vocab=49155.

[hf:ibm-granite/granite-3.0-2b-base; hf]  GQA, RoPE.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=12800,
    vocab=49155,
    mixer="gqa",
    rope=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=1, d_head=16, d_ff=160, vocab=211,
        mixer="gqa", rope=True, dtype="float32", attn_chunk=16,
    )
