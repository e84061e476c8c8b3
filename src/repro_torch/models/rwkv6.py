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

O(1) state per token; the recurrence runs token by token.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import rms_norm

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
    di = nh * dh
    prev = x_tail if x_tail is not None else torch.zeros(
        (B, 1, d), dtype=x.dtype, device=x.device)
    xp = _shift(x, prev)
    xr = _mix(x, xp, p["mu"][0])
    xk = _mix(x, xp, p["mu"][1])
    xv = _mix(x, xp, p["mu"][2])
    xg = _mix(x, xp, p["mu"][3])
    xw = _mix(x, xp, p["mu"][4])
    r = (xr @ p["w_r"]).reshape(B, S, nh, dh)
    k = (xk @ p["w_k"]).reshape(B, S, nh, dh)
    v = (xv @ p["w_v"]).reshape(B, S, nh, dh)
    g = F.silu(xg @ p["w_g"])
    # data-dependent decay, clamped for numerical safety
    dec = p["w_decay_base"] + torch.tanh(xw @ p["w_decay_A"]) \
        @ p["w_decay_B"]
    w = torch.exp(-torch.exp(torch.clamp(dec.float(), -8.0, 2.0)))
    w = w.reshape(B, S, nh, dh)
    u = p["u_bonus"].reshape(nh, dh)
    if state is None:
        state = torch.zeros((B, nh, dh, dh), dtype=torch.float32,
                            device=x.device)
    ys = []
    for t in range(S):
        r_t, k_t, v_t, w_t = (a[:, t].float() for a in (r, k, v, w))
        kv = k_t[..., :, None] * v_t[..., None, :]          # (B,nh,dh,dh)
        m = state + u[..., :, None] * kv
        # einsum does not promote: a wider u (f64 weights) widens m, as
        # jnp's promotion does in the reference
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t.to(m.dtype), m))
        state = w_t[..., :, None] * state + kv
    y = torch.stack(ys, dim=1).reshape(B, S, di).to(x.dtype)
    y = rms_norm(y, p["ln_x"]) * g
    out = y @ p["w_o"]
    return out, (state, x[:, -1:, :])


def rwkv6_decode(p, x, cfg, cache):
    """Single-token step; cache = {"state", "x_tail"} — O(1) memory."""
    out, (state, tail) = rwkv6_mix(
        p, x, cfg, state=cache["state"], x_tail=cache["x_tail"])
    return out, {"state": state, "x_tail": tail}
