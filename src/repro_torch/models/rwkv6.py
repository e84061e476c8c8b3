"""RWKV-6 "Finch" token mixer (arXiv:2404.05892) — attention-free; the
port of ``repro.models.rwkv6``.

Structure (per layer, per head of size dh):
  token shift   x_i = lerp(x_t, x_{t-1}, mu_i)   for i in {r,k,v,g,w}
  projections   r, k, v (d -> di), gate g = silu(.), decay LoRA for w
  data-dependent decay   w_t = exp(-exp(wb + tanh(x_w A) B))  in (0,1)
  WKV recurrence (state S per head, (dh, dh), f32):
      y_t = r_t · (S_{t-1} + diag(u) k_t v_t^T)
      S_t = diag(w_t) S_{t-1} + k_t v_t^T
  head-wise group norm, gate, output projection.

O(1) state per token; the recurrence runs token by token (``scan``).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from .layers import merge_heads, rms_norm, split_heads

LORA_R = 32


def rwkv6_params_shape(cfg):
    d = cfg.d_model
    nh, dh = cfg.ssm_heads, cfg.d_head
    di = nh * dh
    return {
        "mu": (5, d),                # token-shift lerps for r,k,v,g,w
        "w_r": (d, di),
        "w_k": (d, di),
        "w_v": (d, di),
        "w_g": (d, di),
        "w_decay_base": (di,),
        "w_decay_A": (d, LORA_R),
        "w_decay_B": (LORA_R, di),
        "u_bonus": (di,),
        "ln_x": (di,),
        "w_o": (di, d),
    }


def _shift(x, prev):
    """x (B,S,d) -> x_{t-1} with ``prev`` (B,1,d) as the t=0 context."""
    return torch.cat([prev, x[:, :-1, :]], dim=1)


def _mix(x, x_prev, mu):
    return x + (x_prev - x) * mu


# ---------------------------------------------------------------- scan ---

_COUNTERS: list = []


@contextlib.contextmanager
def counted_scans(counter):
    """Inside the block ``scan`` runs its body twice and has ``counter``
    count it as ``n`` trips: the dry run's counting mode, whose
    ``repeated(n)`` scales every count it takes inside it by ``n``, as
    the reference's ``launch/hlo.py`` scales a ``lax.scan`` body's counts
    by its trip count."""
    _COUNTERS.append(counter)
    try:
        yield counter
    finally:
        _COUNTERS.pop()


class _Trips(torch.autograd.Function):
    """Identity on its tensors whose backward multiplies the counter's
    scale by n (``enter``) or divides it by n: put on a scan body's
    outputs and on its inputs, it scales the body's backward as the
    forward is scaled."""

    @staticmethod
    def forward(ctx, counter, n, enter, *ts):
        ctx.counter, ctx.n, ctx.enter = counter, n, enter
        # a missing gradient is made here, shaped and placed as its
        # tensor: autograd's own zeros would be a plain tensor at the
        # global shape in the place of a DTensor's
        ctx.set_materialize_grads(False)
        ctx.inputs = ts
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.enter:
            ctx.counter.scale *= ctx.n
        else:
            ctx.counter.scale //= ctx.n
        grads = [torch.zeros_like(t) if g is None else g
                 for g, t in zip(grads, ctx.inputs)]
        return (None, None, None, *grads)


def scan(step, carry, xs, n: int):
    """``carry, y_t = step(carry, t, *xs)`` for t < n: (the last carry,
    the outputs stacked on dimension 1), as ``lax.scan`` over the token
    axis.

    On its own a Python loop over the n trips.  Inside ``counted_scans``
    the body runs twice: the first trip counted once (it also places the
    initial carry) and the second counted as the other n - 1, forward
    and backward; the carry keeps its full size, and the second output
    is copied n - 1 times into the stack, which is as large as the
    loop's and moves as many bytes."""
    if not _COUNTERS or n < 2:
        ys = []
        for t in range(n):
            carry, y = step(carry, t, *xs)
            ys.append(y)
        return carry, torch.stack(ys, dim=1)
    counter, trips = _COUNTERS[-1], n - 1
    carry, y0 = step(carry, 0, *xs)
    ins = [carry, *xs]
    live = [i for i, t in enumerate(ins)
            if torch.is_grad_enabled() and t.requires_grad]
    if live:
        for i, t in zip(live, _Trips.apply(counter, trips, False,
                                           *(ins[i] for i in live))):
            ins[i] = t
    with counter.repeated(trips):
        carry, y = step(ins[0], 1, *ins[1:])
    if live:
        carry, y = _Trips.apply(counter, trips, True, carry, y)
    y0, y = y0.unsqueeze(1), y.unsqueeze(1)
    return carry, torch.cat(
        [y0, y.expand(y.shape[0], trips, *y.shape[2:])], dim=1)


def rwkv6_mix(p, x, cfg, state=None, x_tail=None):
    """x (B,S,d) -> (y, (state (B,nh,dh,dh), x_tail (B,1,d)))."""
    B, S, d = x.shape
    nh, dh = cfg.ssm_heads, cfg.d_head
    prev = x_tail if x_tail is not None else torch.zeros(
        (B, 1, d), dtype=x.dtype, device=x.device)
    xp = _shift(x, prev)
    xr = _mix(x, xp, p["mu"][0])
    xk = _mix(x, xp, p["mu"][1])
    xv = _mix(x, xp, p["mu"][2])
    xg = _mix(x, xp, p["mu"][3])
    xw = _mix(x, xp, p["mu"][4])
    r = split_heads(xr @ p["w_r"], nh, dh)
    k = split_heads(xk @ p["w_k"], nh, dh)
    v = split_heads(xv @ p["w_v"], nh, dh)
    g = F.silu(xg @ p["w_g"])
    # data-dependent decay, clamped for numerical safety
    dec = p["w_decay_base"] + torch.tanh(xw @ p["w_decay_A"]) \
        @ p["w_decay_B"]
    w = torch.exp(-torch.exp(torch.clamp(dec.float(), -8.0, 2.0)))
    w = split_heads(w, nh, dh)
    u = p["u_bonus"].reshape(nh, dh)
    if state is None:
        state = torch.zeros((B, nh, dh, dh), dtype=torch.float32,
                            device=x.device)

    def step(state, t, r, k, v, w, u):
        r_t, k_t, v_t, w_t = (a[:, t].float() for a in (r, k, v, w))
        kv = k_t[..., :, None] * v_t[..., None, :]          # (B,nh,dh,dh)
        m = state + u[..., :, None] * kv
        # einsum does not promote: a wider u (f64 weights) widens m, as
        # jnp's promotion does in the reference
        y_t = torch.einsum("bhk,bhkv->bhv", r_t.to(m.dtype), m)
        return w_t[..., :, None] * state + kv, y_t

    state, ys = scan(step, state, (r, k, v, w, u), S)
    y = merge_heads(ys).to(x.dtype)
    y = rms_norm(y, p["ln_x"]) * g
    out = y @ p["w_o"]
    return out, (state, x[:, -1:, :])


def rwkv6_decode(p, x, cfg, cache):
    """Single-token step; cache = {"state", "x_tail"} — O(1) memory."""
    out, (state, tail) = rwkv6_mix(
        p, x, cfg, state=cache["state"], x_tail=cache["x_tail"])
    return out, {"state": state, "x_tail": tail}
