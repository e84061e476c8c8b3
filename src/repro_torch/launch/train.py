"""End-to-end training driver; the port of ``repro.launch.train``.

Runs real steps (smoke-scale configs on the CPU; the published widths on
the card): data pipeline -> the eager train_step -> checkpoint manager,
with crash-safe snapshots and restart.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch granite-3-8b --smoke --steps 200 --batch 8 --seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch starcoder2-3b --smoke --steps 60
"""
from __future__ import annotations

import argparse
import time

import torch

from .._device import resolve_device
from ..configs import get_config, get_smoke_config
from ..distributed.fault import CheckpointManager
from ..interop import opt_state_from_reference, params_from_reference
from ..models import lm as lm_mod
from ..train.checkpoint import load_train_state, train_state_arrays
from ..train.data import DataConfig, Prefetcher
from ..train.train_step import TrainConfig, init_opt_state, make_train_step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(lr=args.lr, remat=True)
    params = lm_mod.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed),
        device=device)
    opt_state = init_opt_state(params, tcfg)
    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
        if args.resume and mgr.latest():
            start_step, hp, ho, _meta = load_train_state(mgr.latest())
            params = _cast_like(params, params_from_reference(hp, device))
            opt_state = _cast_like(opt_state,
                                   opt_state_from_reference(ho, device))
            print(f"resumed from step {start_step}")
    step_fn = make_train_step(cfg, tcfg)
    dcfg = DataConfig(vocab=cfg.vocab, batch=args.batch, seq_len=args.seq,
                      seed=args.seed,
                      embeddings_dim=cfg.d_model
                      if cfg.frontend in ("vision", "audio") else 0)
    data = Prefetcher(dcfg, start_step=start_step)
    losses = []
    t0 = time.perf_counter()
    try:
        for step in range(start_step, args.steps):
            batch = {k: torch.as_tensor(v, device=device)
                     for k, v in next(data).items()}
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            if (step + 1) % args.log_every == 0:
                _sync(device)
                dt = (time.perf_counter() - t0) / args.log_every
                tok_s = args.batch * args.seq / dt
                print(f"step {step+1}: loss={losses[-1]:.4f} "
                      f"{dt*1e3:.0f} ms/step {tok_s:.0f} tok/s", flush=True)
                t0 = time.perf_counter()
            if mgr is not None and (step + 1) % mgr.every == 0:
                path = mgr.maybe_save(
                    step + 1, train_state_arrays(params, opt_state))
                print(f"checkpoint -> {path}", flush=True)
    finally:
        data.close()
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


def _cast_like(like, tree):
    """``tree``'s leaves in the dtypes of ``like``'s (the reference's
    ``jnp.asarray(b, a.dtype)`` over the pair)."""
    return {k: _cast_like(v, tree[k]) if isinstance(v, dict)
            else tree[k].to(v.dtype) for k, v in like.items()}


if __name__ == "__main__":
    main()
