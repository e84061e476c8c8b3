"""Model substrate of the port: the unified decoder LM for all assigned
architectures, in plain torch over stacked parameter trees (the port of
``repro.models``)."""
from .config import ModelConfig
from . import layers, lm, mla, moe, rwkv6, ssm
from .lm import (
    decode_step,
    forward,
    init_cache,
    init_params,
    param_shapes,
    partition_specs,
)

__all__ = [
    "ModelConfig", "layers", "lm", "mla", "moe", "rwkv6", "ssm",
    "decode_step", "forward", "init_cache", "init_params", "param_shapes",
    "partition_specs",
]
