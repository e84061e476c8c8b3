"""Core layers: norms, RoPE, GQA attention (chunked prefill + decode);
the port of ``repro.models.layers``.

Plain torch over explicit parameter trees: params are dicts of tensors,
layer functions are ``(params, x, ...) -> y``.  The arithmetic follows
the reference step by step (f32 softmax chains, the same chunk order),
so that the parity tests hold at f32 rounding.

Grouped-query attention does not materialise the key/value heads
repeated to the query heads: the queries are viewed as ``(Hkv, rep)``
groups against the ``Hkv`` cached heads, the same products and sums as
the reference's repeat without its copy of the cache.

Decode caches are written in place: ``gqa_decode`` writes the new slot
into the cache tensors it is given and returns a dict that holds them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG = -1e30


def rms_norm(x, gain, eps: float = 1e-6):
    dt = x.dtype
    x32 = x.float()
    scale = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(dt) * gain


def act_fn(x, kind: str):
    if kind == "silu":
        return F.silu(x)
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(kind)


# ---------------------------------------------------------------- RoPE ---

def rope_angles(positions, dim: int, theta: float):
    """positions (...,) -> cos/sin (..., dim/2)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., S, H, D); cos/sin (S, D/2) broadcast over heads."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


# ----------------------------------------------------- chunked attention ---

def chunked_causal_attention(q, k, v, chunk: int = 512,
                             window: int = 0, scale: Optional[float] = None):
    """Flash-style online-softmax attention, O(S * chunk) memory.

    q (B, S, H, D); k/v (B, S, Hkv, D).  The S keys run in
    ``max(1, S // chunk)`` blocks of ``S // nblocks`` (the last block
    is not ragged: S must divide, as in the reference).  ``window`` > 0
    restricts attention to a trailing window; blocks entirely outside a
    query's window vanish through the online-softmax weights.
    """
    B, S, H, D = q.shape
    Dv = v.shape[-1]
    Hkv = k.shape[2]
    rep = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    nkv = max(1, S // chunk)
    ck = S // nkv
    kc = k.reshape(B, nkv, ck, Hkv, D)
    vc = v.reshape(B, nkv, ck, Hkv, Dv)
    q_pos = torch.arange(S, device=q.device)
    # (B, S, Hkv, rep, D): query head h reads kv head h // rep
    qf = (q * scale).float().reshape(B, S, Hkv, rep, D)
    m_run = torch.full((B, H, S), NEG, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, Dv), dtype=torch.float32, device=q.device)
    for j in range(nkv):
        kb, vb = kc[:, j].float(), vc[:, j].float()
        kv_pos = j * ck + torch.arange(ck, device=q.device)
        scores = torch.einsum("bsgrd,bcgd->bgrsc", qf, kb).reshape(
            B, H, S, ck)
        mask = q_pos[:, None] >= kv_pos[None, :]
        if window > 0:
            mask &= (q_pos[:, None] - kv_pos[None, :]) < window
        scores = torch.where(mask, scores, NEG)
        m_new = torch.maximum(m_run, scores.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(scores - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        pv = torch.einsum("bgrsc,bcgd->bgrsd",
                          p.reshape(B, Hkv, rep, S, ck), vb)
        acc = acc * alpha[..., None] + pv.reshape(B, H, S, Dv)
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, window: int = 0):
    """Single-token attention against a (possibly rolling) KV cache.

    q (B, 1, H, D); caches (B, C, Hkv, D); cache_len a 0-d tensor = the
    number of valid slots.
    """
    B, _, H, D = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    rep = H // Hkv
    qg = (q / math.sqrt(D)).float().reshape(B, Hkv, rep, D)
    scores = torch.einsum("bgrd,bcgd->bgrc", qg, k_cache.float())
    pos = torch.arange(C, device=q.device)
    valid = pos < cache_len
    if window > 0:
        valid &= pos >= torch.clamp(cache_len - window, min=0)
    scores = torch.where(valid, scores, NEG)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrc,bcgd->bgrd", p, v_cache.float())
    return out.reshape(B, 1, H, Dv).to(q.dtype)


# ------------------------------------------------------------ GQA block ---

def gqa_params_shape(cfg):
    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    shapes = {
        "wq": (d, H * dh),
        "wk": (d, Hkv * dh),
        "wv": (d, Hkv * dh),
        "wo": (H * dh, d),
    }
    if cfg.qk_norm:
        shapes["q_norm"] = (dh,)
        shapes["k_norm"] = (dh,)
    return shapes


def gqa_attention(p, x, cfg, positions=None):
    """Full-sequence (training / prefill) GQA attention."""
    B, S, d = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(B, S, H, dh)
    k = (x @ p["wk"]).reshape(B, S, Hkv, dh)
    v = (x @ p["wv"]).reshape(B, S, Hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if cfg.rope:
        pos = positions if positions is not None else torch.arange(
            S, device=x.device)
        cos, sin = rope_angles(pos, dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    o = chunked_causal_attention(q, k, v, chunk=cfg.attn_chunk,
                                 window=cfg.window)
    return o.reshape(B, S, H * dh) @ p["wo"], (k, v)


def _quantize_kv(t):
    """(B,1,Hkv,dh) -> (int8 values, per (B,1,Hkv) scale).  Rounds half
    to even, as the reference."""
    t32 = t.float()
    amax = torch.amax(torch.abs(t32), dim=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(t32 / scale[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale


def _cache_slot(pos, C: int, rolling: bool):
    """The cache slot of position ``pos`` (a 0-d tensor) as a (1,) long
    index: ``pos % C`` in a rolling buffer, else ``min(pos, C - 1)`` (past
    the end the last slot is overwritten, as the reference's clamped
    update does)."""
    slot = pos % C if rolling else torch.clamp(pos, max=C - 1)
    return slot.reshape(1).long()


def gqa_decode(p, x, cfg, cache):
    """One-token decode; cache = {"k": (B,C,Hkv,dh), "v": ..., "len": ()}.

    With ``cfg.kv_cache_int8`` the cache holds int8 values + per-token
    per-head scales (symmetric); dequantization happens at read.  The
    new slot is written into the given cache tensors.
    """
    B, S, d = x.shape
    assert S == 1
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ p["wq"]).reshape(B, 1, H, dh)
    k = (x @ p["wk"]).reshape(B, 1, Hkv, dh)
    v = (x @ p["wv"]).reshape(B, 1, Hkv, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    pos = cache["len"]
    if cfg.rope:
        cos, sin = rope_angles(pos[None], dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    C = cache["k"].shape[1]
    # Rolling buffer when the cache is window-sized: every live slot is
    # inside the window by construction (RoPE phases are absolute, so dot
    # products stay relative-position-correct across wraparound).
    rolling = cfg.window > 0 and C <= cfg.window
    slot = _cache_slot(pos, C, rolling)
    window = 0 if rolling else cfg.window
    if cfg.kv_cache_int8:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        cache["k"].index_copy_(1, slot, kq)
        cache["v"].index_copy_(1, slot, vq)
        cache["k_scale"].index_copy_(1, slot, ks.to(cache["k_scale"].dtype))
        cache["v_scale"].index_copy_(1, slot, vs.to(cache["v_scale"].dtype))
        dt = getattr(torch, cfg.dtype)
        k_full = cache["k"].to(dt) * cache["k_scale"][..., None].to(dt)
        v_full = cache["v"].to(dt) * cache["v_scale"][..., None].to(dt)
        o = decode_attention(q, k_full, v_full, pos + 1, window=window)
        new_cache = {"k": cache["k"], "v": cache["v"],
                     "k_scale": cache["k_scale"],
                     "v_scale": cache["v_scale"], "len": pos + 1}
    else:
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        o = decode_attention(q, cache["k"], cache["v"], pos + 1,
                             window=window)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": pos + 1}
    return o.reshape(B, 1, H * dh) @ p["wo"], new_cache


# ------------------------------------------------------------- gated MLP ---

def mlp_params_shape(cfg):
    d, ff = cfg.d_model, cfg.d_ff
    return {"w1": (d, ff), "w3": (d, ff), "w2": (ff, d)}


def gated_mlp(p, x, cfg):
    h = act_fn(x @ p["w1"], cfg.act) * (x @ p["w3"])
    return h @ p["w2"]
