"""Core layers: norms, RoPE, GQA attention (chunked prefill + decode);
the port of ``repro.models.layers``.

Plain torch over explicit parameter trees: params are dicts of tensors,
layer functions are ``(params, x, ...) -> y``.  The arithmetic follows
the reference step by step (f32 softmax chains, the same chunk order),
so that the parity tests hold at f32 rounding.

Grouped-query attention does not materialise the key/value heads
repeated to the query heads: the queries are viewed as ``(Hkv, rep)``
groups against the ``Hkv`` cached heads, the same products and sums as
the reference's repeat without its copy of the cache.  A ``DTensor``
(the dry run) takes the reference's route instead (``_heads_over_model``).

Decode caches are written in place: ``gqa_decode`` writes the new slot
into the cache tensors it is given and returns a dict that holds them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..runtime.mesh import axis_size, batch_axes, constrain, from_local, \
    is_dtensor, own_block, per_rank

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

def split_heads(t, n_heads: int, d_head: int):
    """(..., n_heads * d_head) -> (..., n_heads, d_head), a view.

    A DTensor is pinned, before the view and after it (and so is its
    gradient), with its batch over the data axes and its heads over
    "model".  Heads that do not divide that axis are viewed whole over
    "model", since DTensor cannot unflatten a dimension whose shards cut
    heads, then sharded unevenly (rank 0 holds ceil(H / 16) of them, the
    block GSPMD pads each device to) by a slice of each rank's own; the
    gradient is whole again at the view."""
    if not is_dtensor(t):
        return t.reshape(*t.shape[:-1], n_heads, d_head)
    ba, mid = batch_axes(), [None] * (t.ndim - 2)
    heads = "model" if n_heads % axis_size("model") == 0 else None
    t = constrain(t, ba, *mid, heads)
    t = constrain(t.reshape(*t.shape[:-1], n_heads, d_head),
                  ba, *mid, heads, None)
    return constrain(t, ba, *mid, "model", None)


def merge_heads(t):
    """(..., H, D) -> (..., H * D), a view; pinned as ``split_heads``
    pins its result."""
    flat = (*t.shape[:-2], t.shape[-2] * t.shape[-1])
    if not is_dtensor(t):
        return t.reshape(flat)
    ba, mid = batch_axes(), [None] * (t.ndim - 3)
    heads = "model" if t.shape[-2] % axis_size("model") == 0 else None
    t = constrain(t, ba, *mid, heads, None)
    return constrain(t.reshape(flat), ba, *mid, heads)


def project_heads(x, w, n_heads: int, d_head: int):
    """``split_heads(x @ w, n_heads, d_head)``.

    A DTensor whose heads outnumber "model" but do not divide it is
    projected as GSPMD projects into padded head blocks: the weight is
    gathered whole (FSDP's gather, and its gradient reduce-scattered
    back) and each rank multiplies by its own heads' columns, so the
    product is never whole over "model"."""
    n = axis_size("model")
    if not is_dtensor(x) or n_heads % n == 0 or n_heads < n:
        return split_heads(x @ w, n_heads, d_head)
    from torch.distributed.tensor import Partial, Replicate, Shard

    x = constrain(x, batch_axes(), *([None] * (x.ndim - 1)))
    w = w.redistribute(w.device_mesh, [Replicate()] * w.device_mesh.ndim)
    h0, h1 = own_block(n_heads)
    # each rank's share of the input's gradient is a partial sum over its
    # heads, and of the weight's over its batch and heads
    xl = x.to_local(grad_placements=[x.placements[0], Partial()])
    wl = w.to_local(grad_placements=[Partial()] * w.device_mesh.ndim)
    y = xl @ wl[:, h0 * d_head:h1 * d_head]
    return from_local(y.reshape(*y.shape[:-1], h1 - h0, d_head),
                      [x.placements[0], Shard(x.ndim - 1)], x,
                      (*x.shape[:-1], n_heads, d_head))


def _repeat_heads(t, rep: int):
    """(B, S, Hkv, D) -> (B, S, Hkv * rep, D), each head ``rep`` times in
    a row (``jnp.repeat`` on the head axis)."""
    if rep == 1:
        return t
    B, S, Hkv, D = t.shape
    return t[:, :, :, None, :].expand(B, S, Hkv, rep, D).reshape(
        B, S, Hkv * rep, D)


def _heads_over_model(q, k, v):
    """The reference's route for DTensors: k and v repeated to q's heads,
    then all three with the batch over the data axes and the HEAD axis
    over "model" (``layers.py:78-84`` of the reference).

    DTensor refuses the plain route's ``(Hkv, rep)`` view of a head axis
    sharded over 16 ranks whenever Hkv or H does not divide 16 (granite
    and grok-1: 8 kv heads; starcoder2: 24 heads; qwen3 and minicpm3: 40;
    hymba: 25).  Head counts that do not divide are sharded unevenly:
    rank 0 holds ceil(H / 16) heads, the block GSPMD pads each device to.
    What it costs: where the heads do not divide, ``split_heads`` has
    gathered the projection over "model" (an all-gather of (B/dp) x S x
    H x dh a layer for q, Hkv x dh for k and v), and the uneven shard is
    then a local slice; where they divide, nothing moves.  The repeat
    moves nothing either (each rank repeats its own kv rows).  Against
    the reference's cells (PERF.md, section 7): qwen3-14b prefill_32k on
    16x16 moves 180 GB a device in all, the reference's 280; hymba-1.5b
    (25 heads, its SSM's heads gathered too) moves 183 against 127."""
    rep = q.shape[2] // k.shape[2]
    ba = batch_axes()
    # the kv heads' own placement pinned on the repeat's result first, so
    # that its gradient reaches the repeat's view as the view can take it
    kv = "model" if k.shape[2] % axis_size("model") == 0 else None
    if rep > 1:
        k, v = (constrain(_repeat_heads(t, rep), ba, None, kv, None)
                for t in (k, v))
    k, v = (constrain(t, ba, None, "model", None) for t in (k, v))
    return constrain(q, ba, None, "model", None), k, v


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
    if is_dtensor(q):
        # the reference's route (heads over "model"), where every rank's
        # attention is its own batch rows and heads: run as on plain
        # tensors, on each rank's blocks
        q, k, v = _heads_over_model(q, k, v)
        return per_rank(
            lambda q, k, v: chunked_causal_attention(q, k, v, chunk,
                                                     window, scale),
            q, k, v,
            out=[((batch_axes(), None, "model", None), (B, S, H, Dv))])
    q_pos = torch.arange(S, device=q.device)
    # (B, S, Hkv, rep, D): query head h reads kv head h // rep
    qf = (q * scale).float().reshape(B, S, Hkv, rep, D)

    def scores_of(kb):
        return torch.einsum("bsgrd,bcgd->bgrsc", qf, kb).reshape(
            B, H, S, ck)

    def pv_of(p, vb):
        return torch.einsum("bgrsc,bcgd->bgrsd",
                            p.reshape(B, Hkv, rep, S, ck),
                            vb).reshape(B, H, S, Dv)

    kc = k.reshape(B, nkv, ck, Hkv, D)
    vc = v.reshape(B, nkv, ck, Hkv, Dv)
    m_run = torch.full((B, H, S), NEG, dtype=torch.float32, device=q.device)
    l_run = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, S, Dv), dtype=torch.float32, device=q.device)
    for j in range(nkv):
        kb, vb = kc[:, j].float(), vc[:, j].float()
        kv_pos = j * ck + torch.arange(ck, device=q.device)
        scores = scores_of(kb)
        mask = q_pos[:, None] >= kv_pos[None, :]
        if window > 0:
            mask &= (q_pos[:, None] - kv_pos[None, :]) < window
        scores = torch.where(mask, scores, NEG)
        m_new = torch.maximum(m_run, scores.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(scores - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + pv_of(p, vb)
        m_run = m_new
        # a block's scores die with it, not with the next block's
        del scores, p
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
    if is_dtensor(q) and is_dtensor(k_cache) and \
            k_cache.placements[-1].is_shard(2):
        # keys and values made a head at a time (MLA's, from
        # ``project_heads``): each rank attends with its own heads
        q = constrain(q, batch_axes(), None, "model", None)
        if is_dtensor(cache_len):
            cache_len = cache_len.to_local()
        return per_rank(
            lambda q, k, v: decode_attention(q, k, v, cache_len, window),
            q, k_cache, v_cache,
            out=[((batch_axes(), None, "model", None), (B, 1, H, Dv))])
    if is_dtensor(q):
        # the cache keeps its placement (cache_specs: the head-feature
        # axis over "model"), and q takes it: the grouped view then cuts
        # no shard, and the scores' partial sums over "model" are
        # all-reduced, (B/dp) x H x C f32 a layer, where moving the
        # cache to whole heads would move all of it every step
        ba = batch_axes()
        q = constrain(constrain(q, ba, None, None, None),
                      ba, None, None, "model")
        k_cache = constrain(k_cache, ba, None, None, "model")
        v_cache = constrain(v_cache, ba, None, None, "model")
    qg = (q / math.sqrt(D)).float().reshape(B, Hkv, rep, D)
    scores = torch.einsum("bgrd,bcgd->bgrc", qg, k_cache.float())
    # a DTensor's partial sums over "model" all-reduced here, as the
    # reference's are (DTensor otherwise picks the collectives torch by
    # torch); a plain tensor is itself
    scores = constrain(scores, batch_axes(), None, None, None)
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
    q = split_heads(x @ p["wq"], H, dh)
    k = split_heads(x @ p["wk"], Hkv, dh)
    v = split_heads(x @ p["wv"], Hkv, dh)
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
    return merge_heads(o) @ p["wo"], (k, v)


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
    q = split_heads(x @ p["wq"], H, dh)
    k = split_heads(x @ p["wk"], Hkv, dh)
    v = split_heads(x @ p["wv"], Hkv, dh)
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
    return merge_heads(o) @ p["wo"], new_cache


# ------------------------------------------------------------- gated MLP ---

def mlp_params_shape(cfg):
    d, ff = cfg.d_model, cfg.d_ff
    return {"w1": (d, ff), "w3": (d, ff), "w2": (ff, d)}


def gated_mlp(p, x, cfg):
    w1 = p["w1"]
    if is_dtensor(w1) and w1.placements[0].is_shard():
        # weights still sharded over the data axes (a decode step's):
        # the tokens move, by placements pinned here, where DTensor picks
        # the collectives torch by torch
        ba, mid = batch_axes(), [None] * (x.ndim - 2)
        h = act_fn(constrain(x @ w1, ba, *mid, "model"), cfg.act) \
            * constrain(x @ p["w3"], ba, *mid, "model")
        return constrain(h, None, *mid, "model") @ p["w2"]
    h = act_fn(x @ w1, cfg.act) * (x @ p["w3"])
    return h @ p["w2"]
