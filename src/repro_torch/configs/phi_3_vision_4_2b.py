"""phi-3-vision-4.2b [vlm] — 32L d=3072 32H (kv=32) ff=8192 vocab=32064.

[hf:microsoft/Phi-3-vision-128k-instruct; hf]  phi3-mini backbone + CLIP
frontend.  Per the assignment, ONLY the transformer backbone is modeled;
the CLIP tower is a stub — train/prefill cells consume precomputed patch
embeddings from ``input_specs()``.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_head=96,
    d_ff=8192,
    vocab=32064,
    mixer="gqa",
    rope=True,
    frontend="vision",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b-smoke", family="vlm", n_layers=2, d_model=48,
        n_heads=4, n_kv_heads=4, d_head=12, d_ff=128, vocab=173,
        mixer="gqa", rope=True, frontend="vision", dtype="float32",
        attn_chunk=16,
    )
