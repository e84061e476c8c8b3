"""rwkv6-1.6b [ssm] — 24L d=2048 (attention-free) ff=7168 vocab=65536.

[arXiv:2404.05892; unverified]  RWKV-6 "Finch": data-dependent decay
linear-attention recurrence, 32 heads of size 64.  O(1) state per token
=> runs the long_500k cell natively.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_head=64,
    d_ff=7168,
    vocab=65536,
    mixer="rwkv6",
    ssm_heads=32,
    rope=False,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=0, n_kv_heads=0, d_head=16, d_ff=160, vocab=227,
        mixer="rwkv6", ssm_heads=4, rope=False, dtype="float32",
        attn_chunk=16,
    )
