"""Training/serving substrate of the port (``repro.train``): optimizers,
the train step, synthetic data, checkpoints and the serving steps."""
from .optimizer import (
    AdafactorConfig,
    AdamWConfig,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
)
from .train_step import (
    TrainConfig,
    cross_entropy,
    init_opt_state,
    make_loss_fn,
    make_train_step,
    opt_state_shapes,
)
from .serve_step import greedy_generate, make_prefill_step, make_serve_step
from .data import DataConfig, Prefetcher, synth_batch
from .checkpoint import load_train_state, place, save_train_state

__all__ = [
    "AdafactorConfig", "AdamWConfig", "adafactor_init", "adafactor_update",
    "adamw_init", "adamw_update", "TrainConfig", "cross_entropy",
    "init_opt_state", "make_loss_fn", "make_train_step", "opt_state_shapes",
    "greedy_generate", "make_prefill_step", "make_serve_step", "DataConfig",
    "Prefetcher", "synth_batch", "load_train_state", "place",
    "save_train_state",
]
