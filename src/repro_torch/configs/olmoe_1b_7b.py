"""olmoe-1b-7b [moe] — 16L d=2048 16H (kv=16) ff=1024 vocab=50304,
MoE 64 experts top-8.  [arXiv:2409.02060; hf]
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1024,
    vocab=50304,
    mixer="gqa",
    mlp="moe",
    n_experts=64,
    top_k=8,
    rope=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_head=16, d_ff=32, vocab=223,
        mixer="gqa", mlp="moe", n_experts=8, top_k=2, rope=True,
        dtype="float32", attn_chunk=16,
    )
