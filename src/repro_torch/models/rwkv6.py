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

import torch
import torch.nn.functional as F

from ..runtime.mesh import batch_axes, constrain, is_dtensor
from .layers import merge_heads, rms_norm, split_heads
from .scan import scan, scan_by_rank

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
    # a DTensor's low-rank product reduced onto the features it decays,
    # over "model" as the heads lie (DTensor reduces its partial sums
    # onto the sequence, or whole, torch by torch)
    dec = constrain(dec, batch_axes(), None, "model")
    w = torch.exp(-torch.exp(torch.clamp(dec.float(), -8.0, 2.0)))
    w = split_heads(w, nh, dh)
    u = p["u_bonus"].reshape(nh, dh)

    def zero_state(r, *_):
        return torch.zeros((r.shape[0], r.shape[2], dh, dh),
                           dtype=torch.float32, device=r.device)

    def step(state, t, r, k, v, w, u):
        r_t, k_t, v_t, w_t = (a[:, t].float() for a in (r, k, v, w))
        kv = k_t[..., :, None] * v_t[..., None, :]          # (B,nh,dh,dh)
        m = state + u[..., :, None] * kv
        # einsum does not promote: a wider u (f64 weights) widens m, as
        # jnp's promotion does in the reference
        y_t = torch.einsum("bhk,bhkv->bhv", r_t.to(m.dtype), m)
        return w_t[..., :, None] * state + kv, y_t

    if is_dtensor(r):
        # each rank's batch rows and heads (the state's too, made or
        # moved there): the scan runs on its blocks
        ba = batch_axes()
        heads = (ba, None, "model", None)
        state, ys = scan_by_rank(
            step, state, (r, k, v, w, u), S,
            carry_spec=(ba, "model", None, None),
            xs_specs=(heads,) * 4 + (("model", None),), ys_spec=heads,
            shapes=((B, nh, dh, dh), (B, S, nh, dh)), init=zero_state)
    else:
        if state is None:
            state = zero_state(r)
        state, ys = scan(step, state, (r, k, v, w, u), S)
    y = merge_heads(ys).to(x.dtype)
    # a DTensor's features pinned over "model" for the output product, as
    # they leave the heads (DTensor moves the norm's rows to a sequence
    # shard on some torches); a plain tensor is itself
    y = constrain(rms_norm(y, p["ln_x"]) * g, batch_axes(), None, "model")
    out = y @ p["w_o"]
    return out, (state, x[:, -1:, :])


def rwkv6_decode(p, x, cfg, cache):
    """Single-token step; cache = {"state", "x_tail"} — O(1) memory."""
    out, (state, tail) = rwkv6_mix(
        p, x, cfg, state=cache["state"], x_tail=cache["x_tail"])
    return out, {"state": state, "x_tail": tail}
