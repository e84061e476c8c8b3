"""qwen3-14b [dense] — 40L d=5120 40H (GQA kv=8) ff=17408 vocab=151936.

[hf:Qwen/Qwen3-8B; hf]  qk_norm, GQA, RoPE.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_head=128,
    d_ff=17408,
    vocab=151936,
    mixer="gqa",
    qk_norm=True,
    rope=True,
    rope_theta=1000000.0,
    attn_chunk=1024,  # fewer online-softmax passes at 32k
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=224, vocab=307,
        mixer="gqa", qk_norm=True, rope=True, dtype="float32", attn_chunk=16,
    )
