"""musicgen-large [audio] — 48L d=2048 32H (kv=32) ff=8192 vocab=2048.

[arXiv:2306.05284; hf]  Decoder-only transformer over EnCodec tokens.
Per the assignment, the EnCodec frontend is a stub: train/prefill cells
consume precomputed frame embeddings; decode cells emit EnCodec-codebook
token ids (vocab 2048).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_head=64,
    d_ff=8192,
    vocab=2048,
    mixer="gqa",
    rope=True,          # sinusoidal in the original; RoPE as positional core
    frontend="audio",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large-smoke", family="audio", n_layers=2, d_model=48,
        n_heads=4, n_kv_heads=4, d_head=12, d_ff=128, vocab=128,
        mixer="gqa", rope=True, frontend="audio", dtype="float32",
        attn_chunk=16,
    )
