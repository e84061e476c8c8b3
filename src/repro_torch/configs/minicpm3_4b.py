"""minicpm3-4b [dense] — 62L d=2560 40H (kv=40) ff=6400 vocab=73448, MLA.

[hf:openbmb/MiniCPM3-4B; hf]  Multi-head Latent Attention with
q_lora_rank=768, kv_lora_rank=256, decoupled RoPE head dim 32 (the
published MiniCPM3 latent dims).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_head=64,
    d_ff=6400,
    vocab=73448,
    mixer="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    rope_head_dim=32,
    rope=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_head=16, d_ff=160, vocab=251,
        mixer="mla", q_lora_rank=24, kv_lora_rank=16, rope_head_dim=8,
        rope=True, dtype="float32", attn_chunk=16,
    )
