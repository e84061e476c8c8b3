"""Optimizers over nested-dict parameter trees; the port of
``repro.train.optimizer``.

AdamW keeps f32 moments regardless of param dtype (mixed-precision
convention); Adafactor-mini keeps factored second moments only (the
low-memory option for the 314B-class configs).

The state trees carry the reference's leaf names (``m``, ``v``,
``step``; ``f`` -> ``row``/``col`` or ``v``), so a checkpoint of either
package loads into the other.  The arithmetic is the reference's, in
f32 tensors: the global norm over every leaf (in the reference's sorted
leaf order), the clip factor, ``b1 ** t`` and ``t ** (-decay)`` with
``t`` an f32 tensor, weight decay added to ``delta`` before ``lr``, and
the result cast back to the parameter's dtype.

The updates run under ``torch.no_grad()`` and write the new values into
the parameter and moment tensors they are given (a stacked leaf one
layer at a time, which bounds the f32 temporaries to one layer's
slice), then return the trees the reference returns: the same tensors,
updated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _paths(tree, prefix=()):
    """(path, leaf) of a nested dict in sorted key order (JAX's leaf
    order for dicts)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _zeros_f32(p):
    # zeros_like: a DTensor parameter's zeros keep its placement
    return torch.zeros_like(p, dtype=torch.float32,
                            memory_format=torch.contiguous_format)


def _slices(*tensors):
    """The tensors whole, or a stacked leaf's (ndim >= 3) layers one at
    a time: elementwise updates and the last-two-axes means of
    Adafactor are the same on each slice of the leading axis."""
    if tensors[0].ndim >= 3:
        return zip(*(t.unbind(0) for t in tensors))
    return [tensors]


def adamw_init(params):
    return {
        "m": _map(_zeros_f32, params),
        "v": _map(_zeros_f32, params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=next(iter(_paths(params)))[1].device),
    }


def _global_norm(tree):
    total = None
    for _, g in _paths(tree):
        s = torch.sum(torch.square(g.to(torch.float32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _clip(grad_clip, gnorm):
    return torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, params
                 ) -> Tuple[Any, Any]:
    step = opt_state["step"] + 1
    gnorm = _global_norm(grads)
    clip = _clip(cfg.grad_clip, gnorm)
    t = step.to(torch.float32)
    c1 = 1 - torch.pow(cfg.b1, t)
    c2 = 1 - torch.pow(cfg.b2, t)

    def upd(g, m, v, p):
        g32 = g.to(torch.float32) * clip
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g32)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g32 * g32)
        m_hat = m / c1
        v_hat = v / c2
        delta = m_hat / (torch.sqrt(v_hat) + cfg.eps)
        delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - cfg.lr * delta).to(p.dtype))

    for path, p in _paths(params):
        g, m, v = (_get(grads, path), _get(opt_state["m"], path),
                   _get(opt_state["v"], path))
        for parts in _slices(g, m, v, p):
            upd(*parts)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}


# ----------------------------------------------------- Adafactor-mini ---

@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    grad_clip: float = 1.0


def adafactor_init(params):
    def fac(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if p.ndim >= 2:
            return {
                "row": torch.zeros(p.shape[:-1], **f32),
                "col": torch.zeros((*p.shape[:-2], p.shape[-1]), **f32),
            }
        return {"v": torch.zeros(p.shape, **f32)}

    return {"f": _map(fac, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=next(iter(_paths(params)))[1].device)}


@torch.no_grad()
def adafactor_update(cfg: AdafactorConfig, grads, opt_state, params):
    step = opt_state["step"] + 1
    t = step.to(torch.float32)
    beta = 1.0 - torch.pow(t, -cfg.decay)
    gnorm = _global_norm(grads)
    clip = _clip(cfg.grad_clip, gnorm)

    def upd_matrix(g, row, col, p):
        g32 = g.to(torch.float32) * clip
        sq = g32 * g32
        row.copy_(beta * row + (1 - beta) * torch.mean(sq, dim=-1))
        col.copy_(beta * col + (1 - beta) * torch.mean(sq, dim=-2))
        rf = row / torch.clamp(torch.mean(row, dim=-1, keepdim=True),
                               min=cfg.eps)
        vhat = rf[..., None] * col[..., None, :]
        step_p(g32, vhat, p)

    def upd_vector(g, v, p):
        g32 = g.to(torch.float32) * clip
        v.copy_(beta * v + (1 - beta) * g32 * g32)
        step_p(g32, v, p)

    def step_p(g32, vhat, p):
        delta = g32 / torch.sqrt(torch.clamp(vhat, min=cfg.eps))
        p.copy_((p.to(torch.float32) - cfg.lr * delta).to(p.dtype))

    for path, p in _paths(params):
        g, f = _get(grads, path), _get(opt_state["f"], path)
        if p.ndim >= 2:
            for parts in _slices(g, f["row"], f["col"], p):
                upd_matrix(*parts)
        else:
            upd_vector(g, f["v"], p)
    return params, {"f": opt_state["f"], "step": step}
