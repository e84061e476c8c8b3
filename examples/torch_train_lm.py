"""End-to-end driver (the PyTorch port): train a ~100M-param LM for a few
hundred steps.

    PYTHONPATH=src python examples/torch_train_lm.py          # ~100M, the card
    PYTHONPATH=src python examples/torch_train_lm.py --tiny   # CI-speed variant
    PYTHONPATH=src python examples/torch_train_lm.py --tiny --device cpu

Exercises the full training substrate on real data flow: deterministic
pipeline -> eager train_step (remat + AdamW) -> crash-safe checkpoints
(under the temporary directory).
"""
import argparse
import os
import tempfile
import time

import torch

from repro_torch._device import resolve_device
from repro_torch.distributed.fault import CheckpointManager
from repro_torch.models import ModelConfig, init_params
from repro_torch.train import (
    DataConfig,
    Prefetcher,
    TrainConfig,
    init_opt_state,
    make_train_step,
)
from repro_torch.train.checkpoint import save_train_state


def model_100m() -> ModelConfig:
    # ~100M params: 12L x 768d GQA decoder (GPT-2-small-class)
    return ModelConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_head=64, d_ff=2048, vocab=32000,
        mixer="gqa", rope=True, dtype="float32", attn_chunk=128,
    )


def model_tiny() -> ModelConfig:
    return ModelConfig(
        name="lm-tiny", family="dense", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_head=32, d_ff=256, vocab=1024,
        mixer="gqa", rope=True, dtype="float32", attn_chunk=32,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = model_tiny() if args.tiny else model_100m()
    steps = args.steps or (60 if args.tiny else 300)
    batch = args.batch or (8 if args.tiny else 4)
    seq = args.seq or (64 if args.tiny else 256)

    n_params = cfg.param_count()
    print(f"model {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{steps} steps @ batch {batch} x seq {seq}")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    tcfg = TrainConfig(lr=3e-4, remat=True)
    opt = init_opt_state(params, tcfg)
    step_fn = make_train_step(cfg, tcfg)
    data = Prefetcher(DataConfig(cfg.vocab, batch, seq))
    ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
    mgr = CheckpointManager(ckpt_dir, every=100)
    t0 = time.perf_counter()
    first = None
    try:
        for step in range(steps):
            b = {k: torch.as_tensor(v, device=device)
                 for k, v in next(data).items()}
            params, opt, m = step_fn(params, opt, b)
            loss = float(m["loss"])
            first = first if first is not None else loss
            if (step + 1) % 20 == 0:
                dt = (time.perf_counter() - t0) / (step + 1)
                print(f"  step {step+1:4d}: loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms/step, "
                      f"{batch*seq/dt:.0f} tok/s)", flush=True)
            if (step + 1) % mgr.every == 0:
                save_train_state(os.path.join(ckpt_dir, f"ck_{step+1}.npz"),
                                 step + 1, params, opt)
    finally:
        data.close()
    print(f"loss: {first:.4f} -> {loss:.4f} "
          f"({'improved' if loss < first else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
