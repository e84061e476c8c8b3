"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style); the port
of ``repro.models.mla``.

Queries and keys/values are produced from low-rank latents; a small
decoupled-RoPE sub-head carries positional information.  The decode cache
stores only the compressed latent (kv_lora_rank + rope dims per token) —
the architecture's raison d'être.

  cq  = x W_dq                       (d -> q_rank),  norm
  q   = cq W_uq                      -> H x (dh + dr)
  ckv = x W_dkv                      (d -> kv_rank + dr)
        split:  latent (kv_rank, normed) | k_rope (dr, shared over heads)
  k_nope, v = latent W_ukv           -> H x (dh + dh)
  attn over [nope ; rope] dims; out proj.
"""
from __future__ import annotations

import torch

from ..runtime.mesh import batch_axes, constrain
from .layers import (
    _cache_slot,
    apply_rope,
    chunked_causal_attention,
    decode_attention,
    merge_heads,
    project_heads,
    rms_norm,
    rope_angles,
    split_heads,
)


def mla_params_shape(cfg):
    d, H, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    qr, kvr, dr = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.rope_head_dim
    return {
        "w_dq": (d, qr),
        "q_norm": (qr,),
        "w_uq": (qr, H * (dh + dr)),
        "w_dkv": (d, kvr + dr),
        "kv_norm": (kvr,),
        "w_ukv": (kvr, H * (dh + dh)),
        "wo": (H * dh, d),
    }


def _project(p, x, cfg, positions):
    B, S, d = x.shape
    H, dh = cfg.n_heads, cfg.d_head
    kvr, dr = cfg.kv_lora_rank, cfg.rope_head_dim
    cq = rms_norm(x @ p["w_dq"], p["q_norm"])
    q = split_heads(cq @ p["w_uq"], H, dh + dr)
    q_nope, q_rope = q[..., :dh], q[..., dh:]
    ckv = x @ p["w_dkv"]
    latent = rms_norm(ckv[..., :kvr], p["kv_norm"])
    k_rope = ckv[..., kvr:].reshape(B, S, 1, dr)
    kv = split_heads(latent @ p["w_ukv"], H, 2 * dh)
    k_nope, v = kv[..., :dh], kv[..., dh:]
    cos, sin = rope_angles(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope, cos, sin)
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(B, S, H, dr)], dim=-1)
    return q_full, k_full, v, ckv


def _mla_full(p, x, cfg, positions=None):
    """Full-sequence MLA: (out, the compressed latents ``ckv``)."""
    pos = positions if positions is not None else torch.arange(
        x.shape[1], device=x.device)
    q, k, v, ckv = _project(p, x, cfg, pos)
    o = chunked_causal_attention(q, k, v, chunk=cfg.attn_chunk)
    return merge_heads(o) @ p["wo"], ckv


def mla_attention(p, x, cfg, positions=None):
    return _mla_full(p, x, cfg, positions)[0], None


def mla_decode(p, x, cfg, cache):
    """cache = {"ckv": (B, C, kvr+dr), "len": ()} — compressed per MLA;
    the new latent is written into ``cache["ckv"]`` in place."""
    B, S, d = x.shape
    assert S == 1
    H, dh = cfg.n_heads, cfg.d_head
    kvr, dr = cfg.kv_lora_rank, cfg.rope_head_dim
    pos = cache["len"]
    q, k_new, v_new, ckv = _project(p, x, cfg, pos[None])
    ckv_cache = cache["ckv"]
    C = ckv_cache.shape[1]
    ckv_cache.index_copy_(1, _cache_slot(pos, C, rolling=False),
                          ckv.to(ckv_cache.dtype))
    # reconstruct K/V for the whole cache from the latents (a DTensor's
    # latents whole over "model" once, for both slices)
    ckv_all = constrain(ckv_cache, batch_axes(), None, None)
    latent = rms_norm(ckv_all[..., :kvr], p["kv_norm"])
    k_rope_c = ckv_all[..., kvr:].reshape(B, C, 1, dr)
    cos, sin = rope_angles(torch.arange(C, device=x.device), dr,
                           cfg.rope_theta)
    k_rope_c = apply_rope(k_rope_c, cos, sin)
    # the latents expand at every cached position each step, a product
    # far larger than its weight: a DTensor's is made a rank's heads at a
    # time (40 do not divide 16), where the heads' view would gather it
    kv = project_heads(latent, p["w_ukv"], H, 2 * dh)
    k_full = torch.cat([kv[..., :dh], k_rope_c.expand(B, C, H, dr)], dim=-1)
    v_full = kv[..., dh:]
    o = decode_attention(q, k_full, v_full, pos + 1)
    new_cache = {"ckv": ckv_cache, "len": pos + 1}
    return merge_heads(o) @ p["wo"], new_cache
