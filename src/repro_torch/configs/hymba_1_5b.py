"""hymba-1.5b [hybrid] — 32L d=1600 25H (GQA kv=5) ff=5504 vocab=32001,
ssm_state=16.  [arXiv:2411.13676; hf]

Parallel attention + mamba heads in every layer; attention is
sliding-window (the published model keeps 3 global-attention layers —
SWA is used throughout here), SSM carries global context.
Sub-quadratic => runs the long_500k cell.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_head=64,
    d_ff=5504,
    vocab=32001,
    mixer="hybrid",
    ssm_state=16,
    ssm_heads=25,
    window=2048,
    rope=True,
    ssm_chunk=128,   # chunk-parallel selective scan
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b-smoke", family="hybrid", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=160, vocab=157,
        mixer="hybrid", ssm_state=4, ssm_heads=4, window=16, rope=True,
        dtype="float32", attn_chunk=16,
    )
