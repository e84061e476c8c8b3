"""Training step: loss, grad, microbatching; the port of
``repro.train.train_step``.

``make_train_step(cfg)`` builds the eager  (params, opt_state, batch)
-> (params, opt_state, metrics)  function.  Batch = {"tokens" |
"embeddings", "labels"}; loss is next-token cross-entropy with label
shift handled by the data pipeline (labels are pre-shifted).  Gradients
come from autograd over the model's torch products, as the reference's
come from ``jax.value_and_grad`` over plain ``jnp`` products.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ..models import lm as lm_mod
from ..models.config import ModelConfig
from ..runtime.mesh import batch_axes, constrain, is_dtensor, placed_like
from . import optimizer as opt_mod


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"          # adamw | adafactor
    lr: float = 3e-4
    weight_decay: float = 0.1
    microbatch: int = 0               # 0 = no gradient accumulation
    remat: bool = True
    remat_policy: Optional[str] = None
    moe_aux_weight: float = 0.01
    z_loss: float = 1e-4


def cross_entropy(logits, labels, z_loss: float = 0.0):
    """Mean next-token xent; logits (B,S,V) f32-accumulated; z-loss reg."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        # DTensor's gather backward scatters into zeros replicated at the
        # global shape (every rank a whole microbatch's f32 logits): the
        # label's logit is selected by a mask instead, whose backward
        # keeps the logits' vocab-parallel placement
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        ll = torch.where(vocab == labels.long()[..., None], logits,
                         0.0).sum(-1)
        ll = constrain(ll, batch_axes(), None)
    else:
        ll = torch.take_along_dim(logits, labels.long()[..., None],
                                  dim=-1)[..., 0]
    loss = torch.mean(lse - ll)
    if z_loss > 0.0:
        loss = loss + z_loss * torch.mean(lse * lse)
    return loss


def make_loss_fn(cfg: ModelConfig, tcfg: TrainConfig):
    def loss_fn(params, batch):
        logits = lm_mod.forward(
            params, cfg,
            tokens=batch.get("tokens"),
            embeddings=batch.get("embeddings"),
            remat=tcfg.remat, remat_policy=tcfg.remat_policy,
        )
        loss = cross_entropy(logits, batch["labels"], tcfg.z_loss)
        return loss, {"loss": loss}

    return loss_fn


def _unflatten(paths, leaves):
    root: dict = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


def value_and_grad(loss_fn, params, batch):
    """(loss, grads) of ``loss_fn(params, batch)``: the gradient tree has
    ``params``' keys, each leaf in its parameter's dtype (zeros for a
    leaf the loss does not reach, as JAX gives)."""
    paths, leaves = zip(*opt_mod._paths(params))
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, _aux = loss_fn(_unflatten(paths, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), _unflatten(paths, grads)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig = TrainConfig()):
    loss_fn = make_loss_fn(cfg, tcfg)
    if tcfg.optimizer == "adamw":
        ocfg = opt_mod.AdamWConfig(lr=tcfg.lr, weight_decay=tcfg.weight_decay)
        opt_update = functools.partial(opt_mod.adamw_update, ocfg)
    else:
        ocfg = opt_mod.AdafactorConfig(lr=tcfg.lr)
        opt_update = functools.partial(opt_mod.adafactor_update, ocfg)

    def grads_of(params, batch):
        if tcfg.microbatch and tcfg.microbatch > 1:
            # gradient accumulation over leading-dim splits of the batch,
            # summed into f32 zeros (bf16 gradients widen before the sum)
            nm = tcfg.microbatch

            def split(x):
                b = x.shape[0]
                return x.reshape(nm, b // nm, *x.shape[1:])

            micro = {k: split(v) for k, v in batch.items()}
            g_acc = opt_mod._map(opt_mod._zeros_f32, params)
            l_acc = None
            for i in range(nm):
                mb = {k: v[i] for k, v in micro.items()}
                l, g = value_and_grad(loss_fn, params, mb)
                for path, gi in opt_mod._paths(g):
                    acc = opt_mod._get(g_acc, path)
                    acc.add_(placed_like(gi, acc))
                del g
                l_acc = l if l_acc is None else l_acc + l
            for _, acc in opt_mod._paths(g_acc):
                acc.div_(nm)
            return l_acc / nm, g_acc
        return value_and_grad(loss_fn, params, batch)

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        new_params, new_opt = opt_update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss}

    return train_step


def init_opt_state(cfg_or_params, tcfg: TrainConfig = TrainConfig()):
    params = cfg_or_params
    if tcfg.optimizer == "adamw":
        return opt_mod.adamw_init(params)
    return opt_mod.adafactor_init(params)


def opt_state_shapes(params_shapes, tcfg: TrainConfig = TrainConfig()):
    """``meta``-tensor tree of the optimizer state (dry-run input), as
    ``models.lm.param_shapes`` gives the parameters'."""
    init = (opt_mod.adamw_init if tcfg.optimizer == "adamw"
            else opt_mod.adafactor_init)
    return init(params_shapes)
