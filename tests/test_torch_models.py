"""The port's model substrate (``repro_torch.models``, ``configs``) held
against the JAX reference on the CPU, in f32.

Every module is run on the same inputs (numpy, from a seed) through the
reference function and its port, the reference's weights carried across
with ``interop.params_from_reference``.  Tolerance, unless a test says
otherwise: ``rtol=1e-5`` and ``atol=1e-5 * max|ref|`` (f32 rounding of
sums taken in another order).
"""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401  (autouse)

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

from repro.configs import ARCH_NAMES as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import cell_supported as ref_cell_supported
from repro.configs import input_specs as ref_input_specs
from repro.models import layers as rl
from repro.models import lm as rlm
from repro.models import mla as rmla
from repro.models import moe as rmoe
from repro.models import rwkv6 as rrwkv
from repro.models import ssm as rssm

from repro_torch import configs as C
from repro_torch.interop import cache_from_reference, params_from_reference
from repro_torch.models import layers as pl
from repro_torch.models import lm as plm
from repro_torch.models import mla as pmla
from repro_torch.models import moe as pmoe
from repro_torch.models import rwkv6 as prwkv
from repro_torch.models import ssm as pssm

RTOL = 1e-5
ATOL = 1e-5          # times max|ref|


def close(port, ref, rtol=RTOL, atol=ATOL):
    ref = np.asarray(ref, np.float64)
    port = (port.detach().double().numpy() if isinstance(port, torch.Tensor)
            else np.asarray(port, np.float64))
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol * scale)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t(a):
    return torch.as_tensor(np.asarray(a))


def rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def layer0(params):
    """Layer 0 of a stacked tree (the reference's layout)."""
    return jax.tree.map(lambda a: a[0], params["layers"])


def smoke_params(arch, seed=0, **replace):
    cfg = ref_smoke(arch)
    if replace:
        cfg = dataclasses.replace(cfg, **replace)
    ref = rlm.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, ref, params_from_reference(np_tree(ref), device="cpu")


def port_cfg(cfg):
    """The port's ModelConfig with the reference config's fields."""
    from repro_torch.models import ModelConfig

    return ModelConfig(**dataclasses.asdict(cfg))


# ------------------------------------------------------------ layers ---

def test_rms_norm_and_act():
    rng = np.random.default_rng(0)
    x, g = rand(rng, 2, 5, 16), rand(rng, 16)
    close(pl.rms_norm(t(x), t(g)), rl.rms_norm(jnp.asarray(x), jnp.asarray(g)))
    for kind in ("silu", "gelu"):
        close(pl.act_fn(t(x), kind), rl.act_fn(jnp.asarray(x), kind))


def test_rope():
    rng = np.random.default_rng(1)
    pos = np.arange(7, dtype=np.int32) + 3
    c_r, s_r = rl.rope_angles(jnp.asarray(pos), 16, 10000.0)
    c_p, s_p = pl.rope_angles(t(pos), 16, 10000.0)
    close(c_p, c_r)
    close(s_p, s_r)
    x = rand(rng, 2, 7, 4, 16)
    close(pl.apply_rope(t(x), c_p, s_p),
          rl.apply_rope(jnp.asarray(x), c_r, s_r))


@pytest.mark.parametrize("S,H,Hkv,chunk,window", [
    (64, 4, 4, 16, 0),      # four blocks
    (64, 4, 2, 16, 16),     # GQA, sliding window
    (40, 4, 2, 16, 0),      # 40 / 16: two blocks of 20 (the ragged case)
    (40, 4, 1, 16, 12),     # ragged with a window and one kv head
    (12, 2, 2, 16, 0),      # shorter than a block
], ids=["blocks", "gqa-window", "ragged", "ragged-window", "short"])
def test_chunked_causal_attention(S, H, Hkv, chunk, window):
    rng = np.random.default_rng(S + H + window)
    q, k, v = (rand(rng, 2, S, h, 8) for h in (H, Hkv, Hkv))
    ref = rl.chunked_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), chunk=chunk,
                                      window=window)
    close(pl.chunked_causal_attention(t(q), t(k), t(v), chunk=chunk,
                                      window=window), ref)


@pytest.mark.parametrize("length,window", [(5, 0), (9, 4), (12, 0)])
def test_decode_attention(length, window):
    rng = np.random.default_rng(length)
    q, kc, vc = rand(rng, 2, 1, 4, 8), rand(rng, 2, 12, 2, 8), \
        rand(rng, 2, 12, 2, 8)
    ref = rl.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                              jnp.asarray(vc), jnp.int32(length),
                              window=window)
    close(pl.decode_attention(t(q), t(kc), t(vc),
                              torch.tensor(length, dtype=torch.int32),
                              window=window), ref)


def _decode_layer(ref_fn, port_fn, cfg, ref_p, port_p, ref_cache, steps,
                  rng):
    """``steps`` one-token decodes of one layer through both packages:
    the outputs and every cache leaf after each step."""
    cache = cache_from_reference(np_tree(ref_cache), device="cpu")
    for _ in range(steps):
        x = rand(rng, 2, 1, cfg.d_model)
        out_r, ref_cache = ref_fn(ref_p, jnp.asarray(x), cfg, ref_cache)
        out_p, cache = port_fn(port_p, t(x), port_cfg(cfg), cache)
        close(out_p, out_r)
        jax.tree.map(lambda p, r: close(p, r), cache, np_tree(ref_cache))


def _layer_cache(cfg, batch, max_len):
    """The reference's one-layer cache (layer 0 of ``init_cache``)."""
    return jax.tree.map(lambda a: a[0], rlm.init_cache(cfg, batch, max_len))


@pytest.mark.parametrize("arch,replace,max_len", [
    ("qwen3-14b", {}, 12),                          # qk_norm
    ("granite-3-8b", {"kv_cache_int8": True}, 12),  # int8 cache
    ("granite-3-8b", {}, 8),                        # past the end: clamp
    ("hymba-1.5b", {}, 12),                         # rolling window of 16
    ("hymba-1.5b", {"window": 5}, 12),              # rolls over
], ids=["qk-norm", "int8", "clamped", "window", "rolling"])
def test_gqa_attention_and_decode(arch, replace, max_len):
    cfg, ref, port = smoke_params(arch, **replace)
    rng = np.random.default_rng(3)
    ref_p, port_p = layer0(ref)["mixer"], plm._index(port["layers"], 0)[
        "mixer"]
    if cfg.mixer == "hybrid":
        ref_p, port_p = ref_p["attn"], port_p["attn"]
    x = rand(rng, 2, 16, cfg.d_model)
    out_r, (k_r, v_r) = rl.gqa_attention(ref_p, jnp.asarray(x), cfg)
    out_p, (k_p, v_p) = pl.gqa_attention(port_p, t(x), port_cfg(cfg))
    close(out_p, out_r)
    close(k_p, k_r)
    close(v_p, v_r)
    if cfg.mixer == "hybrid":
        ref_cache = _layer_cache(cfg, 2, max_len)["attn"]
    else:
        ref_cache = _layer_cache(cfg, 2, max_len)
    _decode_layer(rl.gqa_decode, pl.gqa_decode, cfg, ref_p, port_p,
                  ref_cache, 12, rng)


def test_mla_attention_and_decode():
    cfg, ref, port = smoke_params("minicpm3-4b")
    rng = np.random.default_rng(4)
    ref_p = layer0(ref)["mixer"]
    port_p = plm._index(port["layers"], 0)["mixer"]
    x = rand(rng, 2, 16, cfg.d_model)
    pos = np.arange(16, dtype=np.int32)
    for r, p in zip(rmla._project(ref_p, jnp.asarray(x), cfg,
                                  jnp.asarray(pos)),
                    pmla._project(port_p, t(x), port_cfg(cfg), t(pos))):
        close(p, r)
    close(pmla.mla_attention(port_p, t(x), port_cfg(cfg))[0],
          rmla.mla_attention(ref_p, jnp.asarray(x), cfg)[0])
    _decode_layer(rmla.mla_decode, pmla.mla_decode, cfg, ref_p, port_p,
                  _layer_cache(cfg, 2, 12), 12, rng)


@pytest.mark.parametrize("arch,cf,S", [
    ("olmoe-1b-7b", 1.25, 12),     # drops (capacity 8 for 24 x 2 choices)
    ("olmoe-1b-7b", 100.0, 12),    # dropless
    ("grok-1-314b", 0.5, 12),      # capacity at its floor of 4
    ("olmoe-1b-7b", 1.0, 520),     # 1040 tokens: two routing groups
], ids=["drops", "dropless", "floor", "groups"])
def test_moe_block(arch, cf, S):
    cfg, ref, port = smoke_params(arch, capacity_factor=cf)
    rng = np.random.default_rng(5)
    ref_p = layer0(ref)["mlp"]
    port_p = plm._index(port["layers"], 0)["mlp"]
    x = rand(rng, 2, S, cfg.d_model)
    out_r = rmoe.moe_block(ref_p, jnp.asarray(x), cfg)
    close(pmoe.moe_block(port_p, t(x), port_cfg(cfg)), out_r)
    close(pmoe.moe_aux_loss(port_p, t(x), port_cfg(cfg)),
          rmoe.moe_aux_loss(ref_p, jnp.asarray(x), cfg))
    # the drop cases drop: the output differs from the dropless block's
    if cf < 2:
        free = dataclasses.replace(cfg, capacity_factor=100.0)
        assert not np.allclose(np.asarray(out_r),
                               rmoe.moe_block(ref_p, jnp.asarray(x), free))


def _ssm_cfg(**kw):
    base = dict(name="t", family="hybrid", n_layers=1, d_model=64,
                n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=97,
                mixer="hybrid", ssm_state=8, ssm_heads=4, window=16,
                dtype="float32", attn_chunk=16)
    base.update(kw)
    from repro.models.config import ModelConfig

    return ModelConfig(**base)


def _ssm_params(cfg, seed):
    """The SSM test params of ``tests/test_ssm_chunked.py``, from numpy."""
    rng = np.random.default_rng(seed)
    p = {k: rand(rng, *s, scale=0.3)
         for k, s in rssm.ssm_params_shape(cfg).items()}
    p["A_log"] = np.zeros(cfg.ssm_heads, np.float32)
    p["dt_bias"] = np.full(cfg.ssm_heads, 0.5, np.float32)
    p["D"] = np.full(cfg.ssm_heads, 0.5, np.float32)
    return p


@pytest.mark.parametrize("chunk,S", [(0, 64), (8, 64), (16, 64), (32, 64),
                                     (16, 50)],
                         ids=["sequential", "chunk8", "chunk16", "chunk32",
                              "ragged-fallback"])
def test_ssm_scan(chunk, S):
    cfg = _ssm_cfg(ssm_chunk=chunk)
    p = _ssm_params(cfg, chunk + S)
    rng = np.random.default_rng(S)
    x = rand(rng, 2, S, 64, scale=0.5)
    ref_fn = rssm.ssm_scan_chunked if chunk else rssm.ssm_scan
    port_fn = pssm.ssm_scan_chunked if chunk else pssm.ssm_scan
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: t(v) for k, v in p.items()}
    y_r, (s_r, tail_r) = ref_fn(jp, jnp.asarray(x), cfg)
    y_p, (s_p, tail_p) = port_fn(tp, t(x), port_cfg(cfg))
    close(y_p, y_r)
    close(s_p, s_r)
    close(tail_p, tail_r)
    # carrying state and conv tail into a second call
    x2 = rand(rng, 2, S, 64, scale=0.5)
    y_r, (s_r, tail_r) = ref_fn(jp, jnp.asarray(x2), cfg, state=s_r,
                                conv_tail=tail_r)
    y_p, (s_p, tail_p) = port_fn(tp, t(x2), port_cfg(cfg), state=s_p,
                                 conv_tail=tail_p)
    close(y_p, y_r)
    close(s_p, s_r)


def test_rwkv6_mix_and_decode():
    cfg, ref, port = smoke_params("rwkv6-1.6b")
    rng = np.random.default_rng(6)
    ref_p = layer0(ref)["mixer"]
    port_p = plm._index(port["layers"], 0)["mixer"]
    x = rand(rng, 2, 10, cfg.d_model)
    y_r, (s_r, tail_r) = rrwkv.rwkv6_mix(ref_p, jnp.asarray(x), cfg)
    y_p, (s_p, tail_p) = prwkv.rwkv6_mix(port_p, t(x), port_cfg(cfg))
    close(y_p, y_r)
    close(s_p, s_r)
    close(tail_p, tail_r)
    _decode_layer(rrwkv.rwkv6_decode, prwkv.rwkv6_decode, cfg, ref_p,
                  port_p, _layer_cache(cfg, 2, 12), 12, rng)


@pytest.mark.parametrize("ssm_chunk", [0, 8], ids=["sequential", "chunked"])
def test_hybrid_block_and_decode(ssm_chunk):
    cfg, ref, port = smoke_params("hymba-1.5b", ssm_chunk=ssm_chunk)
    rng = np.random.default_rng(7)
    ref_p = layer0(ref)["mixer"]
    port_p = plm._index(port["layers"], 0)["mixer"]
    x = rand(rng, 2, 16, cfg.d_model)
    close(pssm.hybrid_block(port_p, t(x), port_cfg(cfg))[0],
          rssm.hybrid_block(ref_p, jnp.asarray(x), cfg)[0])
    _decode_layer(rssm.hybrid_decode, pssm.hybrid_decode, cfg, ref_p,
                  port_p, _layer_cache(cfg, 2, 12), 12, rng)


# --------------------------------------------------- the whole model ---

@pytest.mark.parametrize("arch", REF_ARCHS)
def test_forward_and_decode_step(arch):
    """``forward``'s logits (through ``embeddings`` for the vision and
    audio configs), then 12 steps of ``decode_step``: the logits and
    every cache leaf after each step."""
    cfg, ref, port = smoke_params(arch, seed=2)
    pcfg = port_cfg(cfg)
    rng = np.random.default_rng(8)
    B, S = 2, 12
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    if cfg.frontend in ("vision", "audio"):
        emb = rand(rng, B, S, cfg.d_model)
        full_r = rlm.forward(ref, cfg, embeddings=jnp.asarray(emb))
        full_p = plm.forward(port, pcfg, embeddings=t(emb))
    else:
        full_r = rlm.forward(ref, cfg, tokens=jnp.asarray(toks))
        full_p = plm.forward(port, pcfg, tokens=t(toks))
    assert full_p.shape == (B, S, plm.padded_vocab(pcfg))
    close(full_p, full_r)
    cache_r = rlm.init_cache(cfg, B, S)
    cache_p = plm.init_cache(pcfg, B, S, device="cpu")
    jax.tree.map(lambda p, r: close(p, r), cache_p, np_tree(cache_r))
    step_r = jax.jit(rlm.decode_step, static_argnums=1)
    for i in range(S):
        lg_r, cache_r = step_r(ref, cfg, jnp.asarray(toks[:, i:i + 1]),
                               cache_r)
        lg_p, cache_p = plm.decode_step(port, pcfg, t(toks[:, i:i + 1]),
                                        cache_p)
        close(lg_p, lg_r)
        jax.tree.map(lambda p, r: close(p, r), cache_p, np_tree(cache_r))


def test_forward_hidden_head_and_remat():
    """``forward_hidden`` + ``apply_head`` is ``forward``; an untied head;
    ``remat`` under grad gives the same logits and gradients."""
    cfg, ref, port = smoke_params("granite-3-8b", tie_embeddings=False)
    pcfg = port_cfg(cfg)
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 16))
    h_r = rlm.forward_hidden(ref, cfg, tokens=jnp.asarray(toks))
    h_p = plm.forward_hidden(port, pcfg, tokens=t(toks))
    close(h_p, h_r)
    close(plm.apply_head(port, h_p), rlm.apply_head(ref, h_r))
    close(plm.forward(port, pcfg, tokens=t(toks), last_only=True),
          rlm.forward(ref, cfg, tokens=jnp.asarray(toks), last_only=True))
    grads = []
    for remat, policy in ((False, None), (True, None), (True, "dots")):
        p = jax.tree.map(lambda a: a.detach().clone().requires_grad_(True),
                         port)
        logits = plm.forward(p, pcfg, tokens=t(toks), remat=remat,
                             remat_policy=policy)
        logits.square().mean().backward()
        grads.append((logits.detach(), p["layers"]["mlp"]["w1"].grad))
    for lg, g in grads[1:]:
        assert torch.equal(lg, grads[0][0])
        torch.testing.assert_close(g, grads[0][1], rtol=1e-6, atol=0)


# ------------------------------------------------ shapes and configs ---

@pytest.mark.parametrize("arch", REF_ARCHS)
def test_configs_shapes_and_specs(arch):
    """The registry's full and smoke configs, ``param_count``,
    ``param_shapes``, ``partition_specs`` (both modes) and
    ``cache_specs`` equal the reference's; ``init_cache(as_shapes)`` is
    meta tensors of the reference's shapes and dtypes."""
    for cfg_r, cfg_p in ((ref_get_config(arch), C.get_config(arch)),
                         (ref_smoke(arch), C.get_smoke_config(arch))):
        assert dataclasses.asdict(cfg_p) == dataclasses.asdict(cfg_r)
        assert cfg_p.param_count() == cfg_r.param_count()
        assert cfg_p.active_param_count() == cfg_r.active_param_count()
        assert plm.padded_vocab(cfg_p) == rlm.padded_vocab(cfg_r)
        shapes_p = plm.param_shapes(cfg_p)
        jax.tree.map(lambda p, r: (p.shape == r.shape) or pytest.fail(
            f"{p.shape} != {r.shape}"), shapes_p, rlm.param_shapes(cfg_r))
        assert all(p.device.type == "meta"
                   for p in jax.tree.leaves(shapes_p))
        for mode in ("fsdp", "dp"):
            assert plm.partition_specs(cfg_p, mode) == jax.tree.map(
                tuple, rlm.partition_specs(cfg_r, mode),
                is_leaf=lambda s: isinstance(s, PartitionSpec))
        assert plm.cache_specs(cfg_p) == jax.tree.map(
            tuple, rlm.cache_specs(cfg_r),
            is_leaf=lambda s: isinstance(s, PartitionSpec))
        meta = plm.init_cache(cfg_p, 4, 64, as_shapes=True)
        jax.tree.map(lambda p, r: (p.device.type == "meta"
                                   and tuple(p.shape) == r.shape
                                   and str(p.dtype)[6:] == str(r.dtype))
                     or pytest.fail(f"{p} != {r}"),
                     meta, rlm.init_cache(cfg_r, 4, 64, as_shapes=True))


@pytest.mark.parametrize("shape", sorted(REF_SHAPES))
def test_input_specs(shape):
    """``input_specs`` gives meta tensors of the reference's shapes and
    dtypes for every config, and ``cell_supported`` its answers."""
    for arch in REF_ARCHS:
        cfg_r, cfg_p = ref_get_config(arch), C.get_config(arch)
        assert C.cell_supported(cfg_p, C.SHAPES[shape]) == \
            ref_cell_supported(cfg_r, REF_SHAPES[shape])
        spec_p = C.input_specs(cfg_p, C.SHAPES[shape])
        spec_r = ref_input_specs(cfg_r, REF_SHAPES[shape])
        jax.tree.map(lambda p, r: (p.device.type == "meta"
                                   and tuple(p.shape) == r.shape
                                   and str(p.dtype)[6:] == str(r.dtype))
                     or pytest.fail(f"{arch}: {p} != {r}"),
                     spec_p, spec_r)


def test_lp_configs_are_the_reference():
    from repro.configs import LP_CONFIGS as REF_LP

    assert {k: dataclasses.asdict(v) for k, v in C.LP_CONFIGS.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_LP.items()}


def test_chunked_scan_stays_finite_on_long_chunks():
    """A chunk whose log-decay spans more than ~88 (hymba's chunk of 128
    on a 256-token prompt at its published widths) overflows the
    reference's masked exponentials into NaN; the port clamps them and
    agrees with the sequential scan, which both packages compute alike."""
    cfg = _ssm_cfg(ssm_chunk=128, ssm_state=16)
    p = _ssm_params(cfg, 11)
    p["dt_bias"] = np.full(cfg.ssm_heads, 2.0, np.float32)   # dt ~ 2
    x = rand(np.random.default_rng(12), 1, 128, 64, scale=0.5)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: t(v) for k, v in p.items()}
    y_r, _ = rssm.ssm_scan_chunked(jp, jnp.asarray(x), cfg)
    assert not np.isfinite(np.asarray(y_r)).all()
    y_seq, (s_seq, _) = rssm.ssm_scan(jp, jnp.asarray(x), cfg)
    y_p, (s_p, _) = pssm.ssm_scan_chunked(tp, t(x), port_cfg(cfg))
    close(y_p, y_seq, rtol=1e-4, atol=5e-5)
    close(s_p, s_seq, rtol=1e-4, atol=5e-5)


def test_params_from_reference_bf16():
    """A bf16 reference tree (the full configs' dtype) crosses as bf16
    tensors with the same values; ``dtype`` casts the floating leaves."""
    cfg = dataclasses.replace(ref_smoke("qwen3-14b"), dtype="bfloat16")
    ref = rlm.init_params(cfg, jax.random.PRNGKey(0))
    port = params_from_reference(np_tree(ref), device="cpu")
    w = port["layers"]["mixer"]["wq"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(), np.asarray(ref["layers"]["mixer"]["wq"],
                                      np.float32))
    f32 = params_from_reference(np_tree(ref), device="cpu",
                                dtype=torch.float32)
    assert f32["embed"].dtype == torch.float32
    assert torch.equal(f32["embed"], port["embed"].float())
