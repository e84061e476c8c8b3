"""Unified decoder LM over explicit parameter trees; the port of
``repro.models.lm``.

One model definition serves all ten assigned architectures: the token
mixer (GQA / MLA / hybrid attn+SSM / RWKV6) and the channel mixer
(dense gated MLP / top-k MoE) are selected by ``ModelConfig``.
Parameters are a nested dict of tensors in the reference's layout, every
layer leaf STACKED on a leading L axis, so carrying weights across is a
copy a leaf (``interop.params_from_reference``).  The layers run as a
Python loop that indexes the stacked leaves.

Sharding: ``partition_specs`` and ``cache_specs`` give the reference's
PartitionSpec trees with each spec as a tuple of axis names (the form
``distributed.sharding`` uses).  Activations are constrained where the
reference constrains them (``constrain_tokens`` at the embedding, the
hidden state around each block, the logits over "model"), and the
residual between a layer's two sublayers, through
``runtime.mesh.constrain``: under the mesh the dry run installs it
redistributes the ``DTensor`` it is given; on plain tensors, every run
on the CPU or the card, it returns its argument itself.

Decode caches are updated in place: ``decode_step`` writes each layer's
new slot and state into the stacked cache tensors it is given and
returns that cache.  ``prefill_cache`` (the port's own: the reference
prefills a cache only through ``decode_step``) fills an empty cache
from one pass over a prompt.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch

from .._device import resolve_device
from ..runtime.mesh import batch_axes as _batch_axes
from ..runtime.mesh import constrain as _constrain
from ..runtime.mesh import from_local, is_dtensor, own_block
from . import mla as mla_mod
from . import moe as moe_mod
from . import rwkv6 as rwkv_mod
from . import ssm as ssm_mod
from .config import ModelConfig
from .layers import (
    _quantize_kv,
    gated_mlp,
    gqa_attention,
    gqa_decode,
    gqa_params_shape,
    mlp_params_shape,
    rms_norm,
)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def constrain_tokens(x):
    """``x`` with its leading (batch) dimension over the data axes."""
    return _constrain(x, _batch_axes(), *([None] * (x.ndim - 1)))


def _embed(params, tokens):
    """``params["embed"][tokens]``.

    A DTensor's table is looked up as GSPMD partitions the reference's
    gather of a table sharded (vocab over "model", features over the
    data axes): every token on every rank, each rank taking its own
    vocabulary rows' feature block (zeros for the others' rows); the
    result, features over the data axes and partial sums over "model",
    is placed by ``constrain_tokens`` (an all-to-all and an all-reduce).
    DTensor's own rule for the gather moves the whole table on some
    torches, and its gradient has no rule on others."""
    table = params["embed"]
    if not is_dtensor(table):
        return table[tokens.long()]
    from torch.distributed.tensor import Partial, Shard

    tokens = _constrain(tokens, *([None] * tokens.ndim))
    lo, hi = own_block(table.shape[0])
    rows = table.to_local(grad_placements=table.placements)
    idx = tokens.to_local().long() - lo
    hit = (idx >= 0) & (idx < hi - lo)
    local = torch.where(hit[..., None], rows[idx.clamp(0, hi - lo - 1)], 0)
    return from_local(local, [Shard(tokens.ndim), Partial()], table,
                      (*tokens.shape, table.shape[1]))


def _index(tree, i):
    """Layer ``i`` of a stacked tree: each leaf's ``[i]`` (a view)."""
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _unbind(tree):
    """Every layer of a stacked tree, as ``_index`` gives them, from one
    ``unbind`` a leaf: its backward stacks the layers' gradients once,
    where ``[i]`` a layer would add a full-size zero-filled gradient of
    the stacked leaf for every layer."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v) for k, v in tree.items()}
        n = len(next(iter(per_key.values())))
        return [{k: v[i] for k, v in per_key.items()} for i in range(n)]
    return tree.unbind(0)


def _store(tree, i, new) -> None:
    """Write layer ``i``'s new cache ``new`` into the stacked ``tree``,
    skipping leaves that were already updated in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _store(v, i, new[k])
        else:
            dst = v[i]
            if new[k].data_ptr() != dst.data_ptr():
                dst.copy_(new[k])


def _n_layers(params) -> int:
    return params["layers"]["ln1"].shape[0]


# ------------------------------------------------------------- shapes ---

def mixer_params_shape(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.mixer == "gqa":
        return gqa_params_shape(cfg)
    if cfg.mixer == "mla":
        return mla_mod.mla_params_shape(cfg)
    if cfg.mixer == "hybrid":
        return ssm_mod.hybrid_params_shape(cfg)
    if cfg.mixer == "rwkv6":
        return rwkv_mod.rwkv6_params_shape(cfg)
    raise ValueError(cfg.mixer)


def mlp_params_shape_for(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.mlp == "dense":
        return mlp_params_shape(cfg)
    if cfg.mlp == "moe":
        return moe_mod.moe_params_shape(cfg)
    raise ValueError(cfg.mlp)


def layer_params_shape(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": (cfg.d_model,),
        "mixer": mixer_params_shape(cfg),
        "ln2": (cfg.d_model,),
        "mlp": mlp_params_shape_for(cfg),
    }


def padded_vocab(cfg: ModelConfig) -> int:
    """Pad the embedding row count so the vocab dim shards 16-way.

    Megatron-style: granite (49155), minicpm3 (73448), hymba (32001) are
    not divisible by the model-axis size; pad rows are ordinary learned
    rows that no label ever references.  Logits have the padded width.
    """
    v = cfg.vocab
    if v % 16 == 0:
        return v
    return ((v + 255) // 256) * 256


def _meta(shape, dt):
    return torch.empty(shape, dtype=dt, device="meta")


def param_shapes(cfg: ModelConfig):
    """Full-model tree of ``meta`` tensors: shapes and dtypes, nothing
    allocated (the dry-run input)."""
    dt = _dtype(cfg)
    L = cfg.n_layers
    V = padded_vocab(cfg)

    def stacked(tree):
        return {k: stacked(v) if isinstance(v, dict) else _meta((L, *v), dt)
                for k, v in tree.items()}

    out = {
        "embed": _meta((V, cfg.d_model), dt),
        "layers": stacked(layer_params_shape(cfg)),
        "final_norm": _meta((cfg.d_model,), dt),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = _meta((cfg.d_model, V), dt)
    return out


def _init_leaf(name, shape, dt, gen, device):
    if name.startswith("ln") or "norm" in name or name in (
            "ln_x", "attn_scale", "ssm_scale"):
        return torch.ones(shape, dtype=dt, device=device)
    if name in ("dt_bias", "D", "u_bonus"):
        return torch.full(shape, 0.5, dtype=dt, device=device)
    if name == "A_log":
        return torch.zeros(shape, dtype=dt, device=device)
    if name == "w_decay_base":
        return torch.full(shape, -2.0, dtype=dt, device=device)
    if name == "mu":
        return torch.full(shape, 0.5, dtype=dt, device=device)
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = 1.0 / max(fan_in, 1) ** 0.5
    out = torch.empty(shape, dtype=dt, device=device)
    # stacked matrices are drawn a layer at a time, which bounds the f32
    # draw's memory to one layer's leaf
    for part in (out if len(shape) >= 3 else [out]):
        part.copy_(torch.randn(part.shape, generator=gen,
                               dtype=torch.float32, device=device)
                   .mul_(scale))
    return out


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None):
    """Random initialization on ``device`` (the card unless told): the
    reference's rules (ones for norms and gains, the SSM/RWKV constants,
    N(0, 1/fan_in) matrices drawn in f32 and cast) from ``generator``
    (a generator on ``device``, seeded 0 when not given)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)

    def build(tree):
        return {k: build(v) if isinstance(v, dict)
                else _init_leaf(k, v.shape, v.dtype, gen, dev)
                for k, v in sorted(tree.items())}

    return build(param_shapes(cfg))


# --------------------------------------------------------- partitioning ---

_COL_PARALLEL = {"wq", "wk", "wv", "w1", "w3", "w_in", "w_B", "w_C",
                 "w_uq", "w_ukv", "w_dq", "w_dkv", "w_r", "w_k", "w_v",
                 "w_g", "w_decay_A"}
_ROW_PARALLEL = {"wo", "w2", "w_out", "w_o", "w_decay_B"}


def partition_specs(cfg: ModelConfig, mode: str = "fsdp"):
    """The reference's PartitionSpec tree for params, each spec a tuple
    of mesh axis names (``None`` = replicated, a tuple = several axes).

    mode "dp":   params replicated over data axes, TP over "model".
    mode "fsdp": additionally shard the non-TP major dim over data axes.
    MoE experts: TP over the ff dim.
    """
    fsdp = ("pod", "data") if mode == "fsdp" else None

    def spec_for(name, shape, stacked):
        lead = (None,) if stacked else ()
        nd = len(shape) - (1 if stacked else 0)
        if nd <= 1:
            return (*lead, None) if nd == 1 else lead
        if name in ("w1", "w3", "w2") and nd == 3:      # MoE experts
            if name in ("w1", "w3"):
                return (*lead, None, fsdp, "model")
            return (*lead, None, "model", fsdp)
        if name in _COL_PARALLEL:
            return (*lead, fsdp, "model")
        if name in _ROW_PARALLEL:
            return (*lead, "model", fsdp)
        if name in ("router", "conv"):
            return (*lead, None, None)
        if name == "embed":
            return ("model", fsdp)
        if name == "lm_head":
            return (fsdp, "model")
        return (*lead, *([None] * nd))

    shapes = param_shapes(cfg)

    def build(tree, stacked):
        return {k: build(v, stacked) if isinstance(v, dict)
                else spec_for(k, v.shape, stacked) for k, v in tree.items()}

    specs = {
        "embed": spec_for("embed", shapes["embed"].shape, False),
        "layers": build(shapes["layers"], True),
        "final_norm": (None,),
    }
    if "lm_head" in shapes:
        specs["lm_head"] = spec_for("lm_head", shapes["lm_head"].shape, False)
    return specs


def cache_specs(cfg: ModelConfig):
    """The reference's PartitionSpec tree of ``init_cache`` (stacked L
    leading dim), each spec a tuple of axis names.

    Batch shards over data axes; the head-feature (last) dim over
    "model" (several archs have fewer kv heads than the model axis).
    """
    dp = ("pod", "data")
    kv = (None, dp, None, None, "model")
    if cfg.mixer == "gqa":
        out = {"k": kv, "v": kv, "len": (None,)}
        if cfg.kv_cache_int8:
            out["k_scale"] = (None, dp, None, None)
            out["v_scale"] = (None, dp, None, None)
        return out
    if cfg.mixer == "mla":
        return {"ckv": (None, dp, None, "model"), "len": (None,)}
    if cfg.mixer == "hybrid":
        return {
            "attn": {"k": kv, "v": kv, "len": (None,)},
            "state": (None, dp, None, None, "model"),
            "conv_tail": (None, dp, None, "model"),
        }
    if cfg.mixer == "rwkv6":
        return {
            "state": (None, dp, None, None, "model"),
            "x_tail": (None, dp, None, "model"),
        }
    raise ValueError(cfg.mixer)


# -------------------------------------------------------------- forward ---

def _mixer_apply(p, x, cfg, positions=None):
    if cfg.mixer == "gqa":
        return gqa_attention(p, x, cfg, positions)[0]
    if cfg.mixer == "mla":
        return mla_mod.mla_attention(p, x, cfg, positions)[0]
    if cfg.mixer == "hybrid":
        return ssm_mod.hybrid_block(p, x, cfg, positions)[0]
    if cfg.mixer == "rwkv6":
        return rwkv_mod.rwkv6_mix(p, x, cfg)[0]
    raise ValueError(cfg.mixer)


def _mlp_apply(p, x, cfg):
    if cfg.mlp == "dense":
        return gated_mlp(p, x, cfg)
    return moe_mod.moe_block(p, x, cfg)


def _gathered(layer_p):
    """A layer's weights whole over the data axes, as FSDP gathers them
    before the layer runs (a DTensor's; plain tensors are themselves).
    Its gradient goes back as DTensor's redistribute takes it: the
    partial sums over the batch reduce-scattered to each weight's shard.
    Without it DTensor picks, op by op and torch by torch, whether to
    move a weight or to contract over its data-sharded dimension into
    partial sums of the whole batch.  A decode step's few tokens move
    instead of its weights, as XLA moves them (its FLOPs are XLA's)."""
    from torch.distributed.tensor import Replicate

    def gather(w):
        if not is_dtensor(w) or not w.placements[0].is_shard():
            return w
        return w.redistribute(w.device_mesh,
                              [Replicate(), *w.placements[1:]])

    return {k: _gathered(v) if isinstance(v, dict) else gather(v)
            for k, v in layer_p.items()}


def _block(layer_p, h, cfg):
    layer_p = _gathered(layer_p)
    ba = _batch_axes()
    h = _constrain(h, ba, None, None)
    # the port's constraints more than the reference's: each sublayer's
    # output, and the residual between them.  DTensor carries an output
    # projection's partial sums over "model" through the residual add
    # into the MLP (which then gathers its weights whole), or reduces
    # them there, torch by torch, where GSPMD reduces them into the
    # residual's pinned placement
    h = h + _constrain(
        _mixer_apply(layer_p["mixer"], rms_norm(h, layer_p["ln1"]), cfg),
        ba, None, None)
    h = _constrain(h, ba, None, None)
    h = h + _constrain(
        _mlp_apply(layer_p["mlp"], rms_norm(h, layer_p["ln2"]), cfg),
        ba, None, None)
    return _constrain(h, ba, None, None)


# the matmuls that a remat policy keeps (the reference's
# checkpoint_dots / checkpoint_dots_with_no_batch_dims)
_SAVED_DOTS = {"dots": ("mm", "addmm", "bmm"),
               "dots_no_batch": ("mm", "addmm")}


def _remat(fn, remat_policy):
    from torch.utils import checkpoint as ckpt

    kw = {}
    if remat_policy in _SAVED_DOTS:
        ops = [getattr(torch.ops.aten, n).default
               for n in _SAVED_DOTS[remat_policy]]
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, ops)
    return lambda *a: ckpt.checkpoint(fn, *a, use_reentrant=False, **kw)


def forward_hidden(params, cfg: ModelConfig, tokens=None, embeddings=None,
                   remat: bool = True,
                   remat_policy: Optional[str] = None):
    """Backbone only: tokens/embeddings -> final-norm hidden (B, S, d).
    ``remat`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint``; only while grad is enabled)."""
    if embeddings is not None:
        h = embeddings.to(_dtype(cfg))
    else:
        h = _embed(params, tokens)
    h = constrain_tokens(h)
    block = functools.partial(_block, cfg=cfg)
    if remat and torch.is_grad_enabled():
        block = _remat(block, remat_policy)
    for layer_p in _unbind(params["layers"]):
        h = block(layer_p, h)
    return rms_norm(h, params["final_norm"])


def apply_head(params, h):
    """hidden (..., d) -> logits (..., V)."""
    head = params.get("lm_head")
    w = params["embed"].T if head is None else head
    if is_dtensor(w) and h.numel() // h.shape[-1] > w.shape[0]:
        # more tokens than features (a prefill's or a train step's): the
        # head whole over the data axes, as FSDP gathers it, where DTensor
        # would contract over its data-sharded features into partial sums
        # of the whole batch's logits on every rank; a decode step's few
        # tokens move instead of the head
        w = _constrain(w, None, "model")
    logits = h @ w
    spec = [_batch_axes()] + [None] * (logits.ndim - 2) + ["model"]
    return _constrain(logits, *spec)


def forward(params, cfg: ModelConfig, tokens=None, embeddings=None,
            remat: bool = True, remat_policy: Optional[str] = None,
            last_only: bool = False):
    """tokens (B, S) int OR embeddings (B, S, d) -> logits (B, S, V).

    ``last_only`` computes the head projection only for the final
    position (serving prefill semantics).
    """
    h = forward_hidden(params, cfg, tokens=tokens, embeddings=embeddings,
                       remat=remat, remat_policy=remat_policy)
    if last_only:
        h = h[:, -1:, :]
    return apply_head(params, h)


# --------------------------------------------------------------- decode ---

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               as_shapes: bool = False, device=None):
    """Stacked (L-leading) per-layer decode cache, zeros on ``device``
    (the card unless told); ``as_shapes=True`` gives ``meta`` tensors.
    ``len`` is an (L,) int32; the hybrid and RWKV6 states are f32."""
    dt = _dtype(cfg)
    L = cfg.n_layers
    dev = torch.device("meta") if as_shapes else resolve_device(device)

    def make(shape, dtype=dt):
        return torch.zeros((L, *shape), dtype=dtype, device=dev)

    def scalar_len():
        return torch.zeros((L,), dtype=torch.int32, device=dev)

    if cfg.mixer == "gqa":
        C = min(max_len, cfg.window) if cfg.window > 0 else max_len
        kv = (batch, C, cfg.n_kv_heads, cfg.d_head)
        if cfg.kv_cache_int8:
            return {
                "k": make(kv, torch.int8),
                "v": make(kv, torch.int8),
                "k_scale": make(kv[:3], torch.float32),
                "v_scale": make(kv[:3], torch.float32),
                "len": scalar_len(),
            }
        return {"k": make(kv), "v": make(kv), "len": scalar_len()}
    if cfg.mixer == "mla":
        return {
            "ckv": make((batch, max_len, cfg.kv_lora_rank + cfg.rope_head_dim)),
            "len": scalar_len(),
        }
    if cfg.mixer == "hybrid":
        C = min(max_len, cfg.window) if cfg.window > 0 else max_len
        di = cfg.ssm_heads * cfg.d_head
        kv = (batch, C, cfg.n_kv_heads, cfg.d_head)
        return {
            "attn": {"k": make(kv), "v": make(kv), "len": scalar_len()},
            "state": make((batch, cfg.ssm_heads, cfg.ssm_state, cfg.d_head),
                          torch.float32),
            "conv_tail": make((batch, ssm_mod.CONV_K - 1, di)),
        }
    if cfg.mixer == "rwkv6":
        return {
            "state": make((batch, cfg.ssm_heads, cfg.d_head, cfg.d_head),
                          torch.float32),
            "x_tail": make((batch, 1, cfg.d_model)),
        }
    raise ValueError(cfg.mixer)


def _mixer_decode(p, x, cfg, cache):
    if cfg.mixer == "gqa":
        return gqa_decode(p, x, cfg, cache)
    if cfg.mixer == "mla":
        return mla_mod.mla_decode(p, x, cfg, cache)
    if cfg.mixer == "hybrid":
        return ssm_mod.hybrid_decode(p, x, cfg, cache)
    if cfg.mixer == "rwkv6":
        return rwkv_mod.rwkv6_decode(p, x, cfg, cache)
    raise ValueError(cfg.mixer)


def decode_step(params, cfg: ModelConfig, tokens, cache):
    """tokens (B, 1) + stacked cache -> (logits (B, V), cache); the
    cache's tensors are updated in place and the same cache returned."""
    h = constrain_tokens(_embed(params, tokens))
    ba = _batch_axes()
    for i in range(_n_layers(params)):
        layer_p = _index(params["layers"], i)
        hn = rms_norm(h, layer_p["ln1"])
        mix_out, new_cache = _mixer_decode(layer_p["mixer"], hn, cfg,
                                           _index(cache, i))
        _store(cache, i, new_cache)
        # each sublayer's output and the residual pinned, as in _block
        h = _constrain(h + _constrain(mix_out, ba, None, None),
                       ba, None, None)
        h = h + _constrain(
            _mlp_apply(layer_p["mlp"], rms_norm(h, layer_p["ln2"]), cfg),
            ba, None, None)
        h = _constrain(h, ba, None, None)
    h = rms_norm(h, params["final_norm"])
    return apply_head(params, h)[:, 0, :], cache


# ----------------------------------------------------- cache prefill ---

def _fill_kv(cfg, cache, k, v):
    """One attention layer's cache after a prompt whose keys and values
    (B, S, Hkv, dh) are ``k`` and ``v``: the slots ``decode_step`` would
    have written (a rolling buffer keeps the last C positions at
    ``pos % C``), written in place; ``len`` = S."""
    C, S = cache["k"].shape[1], k.shape[1]
    if S > C and not (cfg.window > 0 and C <= cfg.window):
        raise ValueError(f"a prompt of {S} tokens does not fit a cache of "
                         f"{C} slots")
    first = max(0, S - C)
    slots = torch.arange(first, S, device=k.device) % C
    k, v = k[:, first:], v[:, first:]
    if cfg.kv_cache_int8:
        (kq, ks), (vq, vs) = _quantize_kv(k), _quantize_kv(v)
        for name, t in (("k", kq), ("v", vq), ("k_scale", ks),
                        ("v_scale", vs)):
            cache[name].index_copy_(1, slots, t.to(cache[name].dtype))
    else:
        cache["k"].index_copy_(1, slots, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slots, v.to(cache["v"].dtype))
    return dict(cache, len=torch.full_like(cache["len"], S))


def _mixer_prefill(p, x, cfg, cache):
    """A prompt's pass through one layer's token mixer from an empty
    cache: (out, the layer's cache after it)."""
    if cfg.mixer == "gqa":
        out, (k, v) = gqa_attention(p, x, cfg)
        return out, _fill_kv(cfg, cache, k, v)
    if cfg.mixer == "mla":
        out, ckv = mla_mod._mla_full(p, x, cfg)
        S = x.shape[1]
        if S > cache["ckv"].shape[1]:
            raise ValueError(f"a prompt of {S} tokens does not fit a cache "
                             f"of {cache['ckv'].shape[1]} slots")
        cache["ckv"][:, :S] = ckv.to(cache["ckv"].dtype)
        return out, {"ckv": cache["ckv"],
                     "len": torch.full_like(cache["len"], S)}
    if cfg.mixer == "hybrid":
        attn_out, (k, v) = gqa_attention(p["attn"], x, cfg)
        # from the cache's zero state and conv tail: the conv then pads
        # the prompt with zeros, as the sequence pass does
        ssm_out, (state, tail) = ssm_mod.ssm_apply(
            p["ssm"], x, cfg, state=cache["state"],
            conv_tail=cache["conv_tail"])
        out = 0.5 * (rms_norm(attn_out, p["attn_scale"])
                     + rms_norm(ssm_out, p["ssm_scale"]))
        return out, {"attn": _fill_kv(cfg, cache["attn"], k, v),
                     "state": state, "conv_tail": tail}
    if cfg.mixer == "rwkv6":
        return rwkv_mod.rwkv6_decode(p, x, cfg, cache)
    raise ValueError(cfg.mixer)


@torch.no_grad()
def prefill_cache(params, cfg: ModelConfig, cache, tokens=None,
                  embeddings=None):
    """One pass over a prompt (tokens (B, S) OR embeddings (B, S, d))
    that leaves an empty cache (fresh from ``init_cache``; one whose
    attention already holds tokens raises ``ValueError``) as S
    ``decode_step`` calls would: attention keys and values in their
    slots, MLA latents, the SSM and RWKV6 states and tails, ``len`` = S.
    Returns (the last position's logits (B, V), the cache).  The prompt
    runs as ``forward`` runs it (chunked attention over unquantized keys,
    the chunked SSM scan where configured, MoE routing groups of the
    whole prompt), so it agrees with the token-by-token path to
    rounding where those agree."""
    lens = cache["attn"]["len"] if "attn" in cache else cache.get("len")
    if lens is not None and int(lens.max()) != 0:
        raise ValueError("prefill_cache fills an empty cache")
    if embeddings is not None:
        h = embeddings.to(_dtype(cfg))
    else:
        h = params["embed"][tokens.long()]
    for i in range(_n_layers(params)):
        layer_p = _index(params["layers"], i)
        hn = rms_norm(h, layer_p["ln1"])
        mix_out, new_cache = _mixer_prefill(layer_p["mixer"], hn, cfg,
                                            _index(cache, i))
        _store(cache, i, new_cache)
        h = h + mix_out
        h = h + _mlp_apply(layer_p["mlp"], rms_norm(h, layer_p["ln2"]), cfg)
    h = rms_norm(h[:, -1:, :], params["final_norm"])
    return apply_head(params, h)[:, 0, :], cache
