"""The port's serving steps (``repro_torch.train.serve_step``) held
against the JAX reference on the CPU, in f32, on every smoke config:
``make_prefill_step``'s last-token logits, ``make_serve_step``'s
tokens, logits and cache, and ``greedy_generate``'s tokens (equal).
Tolerance: ``rtol=1e-5``, ``atol=1e-5 * max|ref|``."""
import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401  (autouse)

import jax
import jax.numpy as jnp

from repro.configs import ARCH_NAMES, get_smoke_config
from repro.models import lm as rlm
from repro.train import serve_step as rserve

from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.interop import cache_from_reference, params_from_reference
from repro_torch.models import lm as plm
from repro_torch.train import (
    greedy_generate,
    make_prefill_step,
    make_serve_step,
)


def close(port, ref):
    ref = np.asarray(ref, np.float64)
    port = port.double().numpy()
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


def _setup(arch, seed=0):
    cfg = get_smoke_config(arch)
    ref = rlm.init_params(cfg, jax.random.PRNGKey(seed))
    port = params_from_reference(jax.tree.map(np.asarray, ref),
                                 device="cpu")
    return cfg, port_smoke(arch), ref, port


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("last_only", [True, False])
def test_prefill_step(arch, last_only):
    cfg, pcfg, ref, port = _setup(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(2, 16)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.frontend in ("vision", "audio"):
        batch = {"embeddings": rng.normal(size=(2, 16, cfg.d_model))
                 .astype(np.float32)}
    out_r = rserve.make_prefill_step(cfg, last_only)(
        ref, {k: jnp.asarray(v) for k, v in batch.items()})
    out_p = make_prefill_step(pcfg, last_only)(
        port, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert out_p.shape == (2, plm.padded_vocab(pcfg))
    close(out_p, out_r)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_serve_step_and_greedy_generate(arch):
    """Eight serve steps from a cache carried across (tokens equal,
    logits and cache leaves within tolerance), then ``greedy_generate``
    from a 5-token prompt: the same tokens."""
    cfg, pcfg, ref, port = _setup(arch, seed=3)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    cache_r = rlm.init_cache(cfg, 2, 12)
    cache_p = cache_from_reference(jax.tree.map(np.asarray, cache_r),
                                   device="cpu")
    serve_r = jax.jit(rserve.make_serve_step(cfg))
    serve_p = make_serve_step(pcfg)
    for i in range(8):
        nxt_r, lg_r, cache_r = serve_r(ref, jnp.asarray(toks[:, i:i + 1]),
                                       cache_r)
        nxt_p, lg_p, cache_p = serve_p(port, torch.as_tensor(
            toks[:, i:i + 1]), cache_p)
        assert nxt_p.dtype == torch.int32
        np.testing.assert_array_equal(nxt_p.numpy(), np.asarray(nxt_r))
        close(lg_p, lg_r)
        jax.tree.map(close, cache_p, jax.tree.map(np.asarray, cache_r))
    prompt = toks[:, :5]
    out_r = rserve.greedy_generate(ref, cfg, jnp.asarray(prompt), 7, 12)
    out_p = greedy_generate(port, pcfg, torch.as_tensor(prompt), 7, 12)
    assert out_p.shape == (2, 12)
    np.testing.assert_array_equal(out_p.numpy(), np.asarray(out_r))
    assert int(out_p.max()) < plm.padded_vocab(pcfg)


@pytest.mark.parametrize("arch,replace", [
    *[(a, {}) for a in ARCH_NAMES],
    ("granite-3-8b", {"kv_cache_int8": True}),
    ("hymba-1.5b", {"window": 5}),          # the rolling buffer wraps
    ("hymba-1.5b", {"ssm_chunk": 5}),       # the chunked scan fills it
], ids=[*ARCH_NAMES, "granite-int8", "hymba-rolling", "hymba-chunked"])
def test_prefill_cache_is_the_decode_path(arch, replace):
    """The port's ``prefill_cache`` over a 10-token prompt leaves the
    cache the reference's ten ``decode_step`` calls leave (every leaf),
    and its logits are the tenth step's; decoding on from either cache
    agrees.  MoE runs at a capacity that drops nothing (a prompt's
    routing groups drop what one-token steps keep).  With the int8 cache
    the prompt attends to unquantized keys where the steps attend to
    dequantized ones, so its logits and the dequantized cache are held
    as ``tests/test_models.py`` holds int8 decoding against the
    full-precision cache (within 5 % of the largest value)."""
    import dataclasses

    base = get_smoke_config(arch)
    if base.mlp == "moe":
        replace = dict(replace, capacity_factor=base.n_experts / base.top_k)
    cfg = dataclasses.replace(base, **replace)
    pcfg = dataclasses.replace(port_smoke(arch), **replace)
    ref = rlm.init_params(cfg, jax.random.PRNGKey(5))
    port = params_from_reference(jax.tree.map(np.asarray, ref),
                                 device="cpu")
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, size=(2, 12)).astype(np.int32)
    cache_r = rlm.init_cache(cfg, 2, 12)
    step_r = jax.jit(rlm.decode_step, static_argnums=1)
    for i in range(10):
        lg_r, cache_r = step_r(ref, cfg, jnp.asarray(toks[:, i:i + 1]),
                               cache_r)
    cache_p = plm.init_cache(pcfg, 2, 12, device="cpu")
    lg_p, cache_p = plm.prefill_cache(port, pcfg, cache_p,
                                      tokens=torch.as_tensor(toks[:, :10]))
    if cfg.kv_cache_int8:
        scale = float(np.abs(np.asarray(lg_r)).max())
        assert float((lg_p - torch.as_tensor(np.array(lg_r))).abs()
                     .max()) < 0.05 * scale
        assert torch.equal(lg_p.argmax(-1), torch.as_tensor(
            np.asarray(lg_r).argmax(-1)))
    else:
        close(lg_p, lg_r)

    cache_r = jax.tree.map(np.asarray, cache_r)
    if cfg.kv_cache_int8:
        for k in ("k", "v"):
            deq_p = cache_p[k].double() * cache_p[k + "_scale"][..., None]
            deq_r = cache_r[k] * cache_r[k + "_scale"][..., None]
            assert float(np.abs(deq_p.numpy() - deq_r).max()) < \
                0.05 * float(np.abs(deq_r).max())
        np.testing.assert_array_equal(cache_p["len"].numpy(),
                                      cache_r["len"])
    else:
        jax.tree.map(close, cache_p, cache_r)
    for i in range(10, 12):
        lg_r, cache_r = step_r(ref, cfg, jnp.asarray(toks[:, i:i + 1]),
                               cache_r)
        lg_p, cache_p = plm.decode_step(port, pcfg, torch.as_tensor(
            toks[:, i:i + 1]), cache_p)
        if not cfg.kv_cache_int8:
            close(lg_p, lg_r)
    if cfg.mixer != "rwkv6":     # an attention cache that holds tokens
        with pytest.raises(ValueError):
            plm.prefill_cache(port, pcfg, cache_p,
                              tokens=torch.as_tensor(toks[:, :2]))
