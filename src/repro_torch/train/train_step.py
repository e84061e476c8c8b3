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
from ..runtime.mesh import batch_axes, constrain, from_local, is_dtensor, \
    own_block, placed_like
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
    if is_dtensor(logits):
        from torch.distributed.tensor import Partial

        # vocab-parallel, as GSPMD partitions the reference's: DTensor
        # has no rule for logsumexp over a sharded dimension and gathers
        # whole rows (every rank its microbatch's f32 logits at the full
        # vocabulary), so it runs as jax.nn.logsumexp's own steps, each
        # reduction over the vocab an all-reduce of (B/dp) x S
        ba = batch_axes()
        m = constrain(logits.detach().amax(-1), ba, None)
        lse = constrain(torch.exp(logits - m[..., None]).sum(-1), ba, None)
        lse = torch.log(lse) + m
        # the label's logit taken on the rank whose vocabulary block holds
        # it (zero on the others) and summed over "model": DTensor's own
        # rules for the gather, or for a mask over the vocabulary, make
        # whole rows on some torches, and their backward too
        labels = constrain(labels, ba, None)
        lo, hi = own_block(logits.shape[-1])
        idx = labels.to_local().long() - lo
        hit = (idx >= 0) & (idx < hi - lo)
        local = torch.take_along_dim(
            logits.to_local(grad_placements=logits.placements),
            idx.clamp(0, hi - lo - 1)[..., None], dim=-1)[..., 0]
        ll = constrain(from_local(torch.where(hit, local, 0.0),
                                  [labels.placements[0], Partial()],
                                  labels, labels.shape), ba, None)
    else:
        lse = torch.logsumexp(logits, dim=-1)
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


def _split_strided(x, nm: int):
    """A DTensor batch placed as the dry run places a microbatched one
    (``_StridedShard(0, split_factor=nm)``: each rank holds its rows of
    every microbatch, in order) split as ``x.reshape(nm, b // nm, ...)``:
    each rank's block is that view of its own rows, with the microbatch's
    rows sharded as the batch's.  A local view, as on torches whose
    DTensor refuses the strided split itself."""
    from torch.distributed.tensor import Shard

    local = x.to_local()
    return from_local(
        local.reshape(nm, local.shape[0] // nm, *local.shape[1:]),
        [Shard(1) if getattr(p, "dim", None) == 0 else p
         for p in x.placements],
        x, (nm, x.shape[0] // nm, *x.shape[1:]))


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
                if is_dtensor(x):
                    return _split_strided(x, nm)
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
