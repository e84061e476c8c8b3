"""starcoder2-3b [dense] — 30L d=3072 24H (GQA kv=2) ff=12288 vocab=49152.

[arXiv:2402.19173; hf]  GQA, RoPE.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_head=128,
    d_ff=12288,
    vocab=49152,
    mixer="gqa",
    rope=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b-smoke", family="dense", n_layers=2, d_model=48,
        n_heads=6, n_kv_heads=2, d_head=8, d_ff=192, vocab=199,
        mixer="gqa", rope=True, dtype="float32", attn_chunk=16,
    )
