"""Top-k routed mixture-of-experts (OLMoE 64e/top-8, Grok-1 8e/top-2);
the port of ``repro.models.moe``.

The grouped one-hot dispatch (Shazeer-style, two einsums) over routing
groups of ``GROUP`` tokens.  Capacity is ``ceil(group_tokens * top_k /
E * capacity_factor)`` (at least 4); overflowing (token, choice) pairs
are dropped in the order of the cumsum over the (token, choice)
flattening, and their residual stream passes through.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..runtime.mesh import axis_size, batch_axes, constrain, is_dtensor, \
    per_rank
from .layers import act_fn

GROUP = 512   # tokens per routing group


def moe_params_shape(cfg):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": (d, E),
        "w1": (E, d, ff),
        "w3": (E, d, ff),
        "w2": (E, ff, d),
    }


def _capacity(tokens_per_group: int, top_k: int, n_experts: int,
              factor: float) -> int:
    c = math.ceil(tokens_per_group * top_k / n_experts * factor)
    return max(4, int(c))


def _group_spec(g: int, xt):
    """Where a DTensor's routing groups (g, tg, d) lie under the dry
    run's mesh: the groups over the data axes when they divide them
    (prefill and training: every group's dispatch, experts and combine
    local to its rank, the expert weights gathered as FSDP gathers any
    other), else the tokens of the one group (decode: the dispatched
    tokens are summed over the data axes).  The experts' inputs and
    outputs are pinned there too, with whole features: DTensor otherwise
    shards the experts over the data axes and the capacity slots over
    "model", which its views of the combine cannot follow."""
    if not is_dtensor(xt):
        return (None, None)
    ba = batch_axes()
    return (ba, None) if g % axis_size(ba) == 0 else (None, ba)


def _route(logits, k: int, C: int):
    """Routing groups' logits (g, tg, E) -> (dispatch, combine), each
    (g, tg, E, C): the top-k experts of each token and its slot in each
    expert's queue of C, the probabilities folded into combine."""
    g, tg, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)              # (g, tg, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # expert one-hot per choice: (g, tg, k, E)
    oh = F.one_hot(top_i, E).float()
    # position of each (token, choice) within its expert queue
    pos = torch.cumsum(oh.reshape(g, tg * k, E), dim=1).reshape(
        g, tg, k, E) * oh - 1.0
    keep = (pos < C) & (oh > 0)
    pos = torch.where(keep, pos, 0.0)
    # one-hot slots as jax.nn.one_hot makes them (a comparison with the
    # slot numbers), the same 0/1 values as F.one_hot's without its int64
    # copy of (g, tg, k, E, C)
    pos_oh = (pos.long()[..., None]
              == torch.arange(C, device=pos.device)).float()
    # dispatch (g, tg, E, C) / combine with routing probs folded in
    kept = oh * keep
    dispatch = torch.einsum("gske,gskec->gsec", kept, pos_oh)
    # the probabilities folded into the 0/1 choices before the one-hot
    # slots, not after: every product is exact and a (token, expert)
    # pair has one choice at most, so this is the three-operand einsum
    # bit for bit without its (g, tg, k, E, C) intermediate
    combine = torch.einsum("gske,gskec->gsec", kept * top_p[..., None],
                           pos_oh)
    return dispatch, combine


def moe_block(p, x, cfg):
    """x (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    g = max(1, T // GROUP)
    tg = T // g
    xt = x.reshape(g, tg, d)
    gspec = _group_spec(g, xt)
    xt = constrain(xt, *gspec, None)
    logits = (xt @ p["router"]).float()                      # (g, tg, E)
    C = _capacity(tg, k, E, cfg.capacity_factor)
    if is_dtensor(logits) and gspec[0] is not None:
        # every routing group on its own rank: the routing, a function of
        # its group alone, runs on each rank's groups (DTensor's rules
        # move the choices' gradients whole on some torches)
        shape = (g, tg, E, C)
        dispatch, combine = per_rank(
            lambda logits: _route(logits, k, C), logits,
            out=[((gspec[0], None, None, None), shape)] * 2)
    else:
        dispatch, combine = _route(logits, k, C)

    xin = torch.einsum("gsec,gsd->egcd", dispatch.to(x.dtype), xt)
    xin = constrain(xin, None, gspec[0], None, None)
    h = act_fn(torch.einsum("egcd,edf->egcf", xin, p["w1"]), cfg.act)
    h = h * torch.einsum("egcd,edf->egcf", xin, p["w3"])
    out_e = torch.einsum("egcf,efd->egcd", h, p["w2"])
    out_e = constrain(out_e, None, gspec[0], None, None)
    out = torch.einsum("gsec,egcd->gsd", combine.to(x.dtype), out_e)
    return constrain(out, *gspec, None).reshape(B, S, d)


def moe_aux_loss(p, x, cfg):
    """Load-balancing auxiliary loss (Switch-style): E * sum(f_e * p_e)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = (x.reshape(-1, d) @ p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_i = torch.topk(probs, k, dim=-1)[1]
    frac = torch.mean(F.one_hot(top_i, E).float(), dim=(0, 1))
    imp = torch.mean(probs, dim=0)
    return E * torch.sum(frac * imp)
