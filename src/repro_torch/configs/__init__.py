"""Selectable configs: 10 assigned architectures + the paper's LP configs
(the port of ``repro.configs``)."""
from .registry import ARCH_NAMES, all_configs, get_config, get_smoke_config
from .shapes import SHAPES, ShapeSpec, cell_supported, input_specs
from .pdhg_paper import LP_CONFIGS, LPConfig

__all__ = [
    "ARCH_NAMES", "all_configs", "get_config", "get_smoke_config",
    "SHAPES", "ShapeSpec", "cell_supported", "input_specs",
    "LP_CONFIGS", "LPConfig",
]
