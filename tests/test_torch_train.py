"""The port's training substrate (``repro_torch.train``: optimizers, the
train step, data, checkpoints; ``launch.train``; the training example)
held against the JAX reference on the CPU, in f32.

The reference's weights, batches and optimizer states cross as numpy
(``interop.params_from_reference``, ``opt_state_from_reference``).
Tolerances, stated at each test: the optimizers ``rtol=1e-6``,
``atol=1e-6 * max|ref|`` after 5 steps; the train step loss
``rtol=1e-5``, gradients ``atol=1e-5 * max|g|`` a leaf and parameters
``atol=1e-5 * max|p|`` (see ``close_after_adamw``); microbatching the
reference test's own bounds (``tests/test_train.py:62-65``).
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_parity import one_torch_thread  # noqa: F401  (autouse)

import jax
import jax.numpy as jnp

from repro.configs import ARCH_NAMES, get_smoke_config
from repro.models import lm as rlm
from repro.train import checkpoint as rck
from repro.train import data as rdata
from repro.train import optimizer as ropt
from repro.train import train_step as rts

from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.interop import opt_state_from_reference, \
    params_from_reference
from repro_torch.models import lm as plm
from repro_torch.train import (
    AdafactorConfig,
    AdamWConfig,
    DataConfig,
    Prefetcher,
    TrainConfig,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    cross_entropy,
    init_opt_state,
    load_train_state,
    make_loss_fn,
    make_train_step,
    opt_state_shapes,
    place,
    save_train_state,
    synth_batch,
)
from repro_torch.train.train_step import value_and_grad

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def leaves(tree, prefix=""):
    """(path, leaf) of a nested dict, sorted by path."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += leaves(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def close_tree(port, ref, rtol, atol):
    """Every leaf of ``port`` within ``rtol`` and ``atol * max|ref leaf|``
    of ``ref``'s (the same paths)."""
    p, r = leaves(port), leaves(np_tree(ref))
    assert [k for k, _ in p] == [k for k, _ in r]
    for (k, a), (_, b) in zip(p, r):
        b = np.asarray(b, np.float64)
        a = a.detach().double().numpy() if torch.is_tensor(a) else \
            np.asarray(a, np.float64)
        assert a.shape == b.shape, k
        scale = float(np.abs(b).max()) if b.size else 0.0
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale,
                                   err_msg=k)


def close_after_adamw(port, ref, grads, lr, eps=1e-8, tol=1e-5):
    """Parameters after one AdamW step from the same weights, each entry
    within ``tol * max|p|`` of the reference's, plus what the gradient's
    own tolerance (``tol * max|g|`` of the leaf, ``grads`` the
    reference's) moves that entry through the step: the first step's
    ``delta = g / (|g| + eps)`` changes by ``eps * dg / (|g| + eps)**2``,
    which is below 1e-3 of ``lr`` wherever ``|g|`` exceeds about 3e-6
    of ``max|g|``, and up to ``lr`` where ``|g|`` is near ``eps``: there
    f32 rounding of the gradient decides the entry's update, in the
    reference as in the port."""
    p, r, g = leaves(port), leaves(np_tree(ref)), leaves(np_tree(grads))
    assert [k for k, _ in p] == [k for k, _ in r] == [k for k, _ in g]
    for (k, a), (_, b), (_, gr) in zip(p, r, g):
        a = a.detach().double().numpy()
        b, gr = np.asarray(b, np.float64), np.abs(np.asarray(gr, np.float64))
        dg = tol * float(gr.max())
        bound = (tol * float(np.abs(b).max())
                 + lr * np.minimum(2.0, eps * dg / (gr + eps) ** 2))
        excess = np.abs(a - b) - bound
        assert excess.max() <= 0, (k, float(np.abs(a - b).max()))


# ------------------------------------------------------------ optimizers ---

def _random_tree(rng):
    return {"layers": {"w": rng.normal(size=(3, 6, 5)).astype(np.float32),
                       "ln": rng.normal(size=(3, 6)).astype(np.float32)},
            "embed": rng.normal(size=(7, 6)).astype(np.float32),
            "bias": rng.normal(size=(5,)).astype(np.float32)}


OPTIMIZERS = {
    "adamw": (ropt.adamw_init, ropt.adamw_update,
              ropt.AdamWConfig(lr=1e-2), adamw_init, adamw_update,
              AdamWConfig(lr=1e-2)),
    "adafactor": (ropt.adafactor_init, ropt.adafactor_update,
                  ropt.AdafactorConfig(lr=1e-2), adafactor_init,
                  adafactor_update, AdafactorConfig(lr=1e-2)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    """Five updates on a random tree with random gradients (the third
    large enough to clip): parameters and every state leaf within
    rtol=1e-6, atol=1e-6 * max|ref|; ``step`` equal and int32."""
    r_init, r_upd, r_cfg, p_init, p_upd, p_cfg = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    tree = _random_tree(rng)
    r_params = jax.tree.map(jnp.asarray, tree)
    p_params = params_from_reference(tree, device="cpu")
    r_state, p_state = r_init(r_params), p_init(p_params)
    for i in range(5):
        g = jax.tree.map(
            lambda a: (rng.normal(size=a.shape) * (30.0 if i == 2 else 0.1))
            .astype(np.float32), tree)
        r_params, r_state = r_upd(r_cfg, jax.tree.map(jnp.asarray, g),
                                  r_state, r_params)
        p_params, p_state = p_upd(p_cfg, params_from_reference(
            g, device="cpu"), p_state, p_params)
    close_tree(p_params, r_params, 1e-6, 1e-6)
    r_state = np_tree(r_state)
    assert p_state["step"].dtype == torch.int32
    assert int(p_state["step"]) == int(r_state.pop("step")) == 5
    close_tree({k: v for k, v in p_state.items() if k != "step"},
               r_state, 1e-6, 1e-6)


def _quadratic_losses(update_fn, init_fn, cfg, steps=60):
    params = {"w": torch.as_tensor(np.random.default_rng(0).normal(size=(8,)),
                                   dtype=torch.float32)}
    target = torch.arange(8.0)
    opt = init_fn(params)
    losses = []
    for _ in range(steps):
        grads = {"w": 2 * (params["w"] - target)}
        params, opt = update_fn(cfg, grads, opt, params)
        losses.append(float(torch.sum((params["w"] - target) ** 2)))
    return losses


def test_adamw_decreases_quadratic():
    losses = _quadratic_losses(adamw_update, adamw_init,
                               AdamWConfig(lr=0.1, weight_decay=0.0))
    assert losses[-1] < losses[0] * 0.05


def test_adafactor_decreases_quadratic():
    losses = _quadratic_losses(adafactor_update, adafactor_init,
                               AdafactorConfig(lr=0.3))
    assert losses[-1] < losses[0] * 0.2


# ------------------------------------------------------------ train step ---

def _batch(cfg, batch=2, seq=16, step=0):
    return synth_batch(DataConfig(
        cfg.vocab, batch, seq, seed=1,
        embeddings_dim=cfg.d_model
        if cfg.frontend in ("vision", "audio") else 0), step)


def _setup(arch, seed=0):
    cfg = get_smoke_config(arch)
    ref = rlm.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, ref, params_from_reference(np_tree(ref), device="cpu")


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(2, 5, 37)) * 4).astype(np.float32)
    labels = rng.integers(0, 37, size=(2, 5)).astype(np.int32)
    for z in (0.0, 1e-4):
        ref = float(rts.cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels), z))
        port = float(cross_entropy(torch.as_tensor(logits),
                                   torch.as_tensor(labels), z))
        np.testing.assert_allclose(port, ref, rtol=1e-6)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step_matches_reference(arch):
    """One AdamW step (``TrainConfig()``) of every smoke config on the
    reference's weights and batch: loss rtol=1e-5; the gradients (the
    step's ``value_and_grad``) atol=1e-5 * max|g| a leaf; the updated
    parameters atol=1e-5 * max|p| (``close_after_adamw``); the first
    moment atol=1e-5 * max|m| (it is the clipped gradient, scaled)."""
    cfg, ref, port = _setup(arch)
    batch = _batch(cfg)
    tcfg = TrainConfig()
    r_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    p_batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    _, r_g = jax.jit(jax.value_and_grad(rts.make_loss_fn(cfg, tcfg),
                                        has_aux=True))(ref, r_batch)
    _, p_g = value_and_grad(make_loss_fn(port_smoke(arch), tcfg), port,
                            p_batch)
    close_tree(p_g, r_g, 0.0, 1e-5)
    r_p, r_o, r_m = jax.jit(rts.make_train_step(cfg, tcfg))(
        ref, rts.init_opt_state(ref, tcfg), r_batch)
    p_p, p_o, p_m = make_train_step(port_smoke(arch), tcfg)(
        port, init_opt_state(port, tcfg), p_batch)
    np.testing.assert_allclose(float(p_m["loss"]), float(r_m["loss"]),
                               rtol=1e-5)
    close_after_adamw(p_p, r_p, r_g, tcfg.lr)
    r_o = np_tree(r_o)
    assert int(p_o["step"]) == int(r_o["step"]) == 1
    close_tree(p_o["m"], r_o["m"], 0.0, 1e-5)
    close_tree(p_o["v"], r_o["v"], 0.0, 1e-5)


@pytest.mark.parametrize("remat,policy", [(False, None), (True, None),
                                          (True, "dots"),
                                          (True, "dots_no_batch")])
def test_remat_gradients_match_reference(remat, policy):
    """The gradients under each remat setting against the reference's
    ``value_and_grad`` of the same loss: rtol=1e-5, atol=1e-5 *
    max|ref leaf|."""
    cfg, ref, port = _setup("granite-3-8b")
    batch = _batch(cfg)
    tcfg = TrainConfig(remat=remat, remat_policy=policy)
    (r_loss, _), r_g = jax.value_and_grad(
        rts.make_loss_fn(cfg, tcfg), has_aux=True)(
        ref, {k: jnp.asarray(v) for k, v in batch.items()})
    p_loss, p_g = value_and_grad(
        make_loss_fn(port_smoke("granite-3-8b"), tcfg), port,
        {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(p_loss), float(r_loss), rtol=1e-5)
    close_tree(p_g, r_g, 1e-5, 1e-5)


def test_microbatch_equals_full_batch_grads():
    """Gradient accumulation is exact (the reference test's bounds: loss
    rtol=1e-5, parameters within 5e-3), and the port's microbatched
    step matches the reference's (loss rtol=1e-5, parameters atol=1e-5
    * max|p| by ``close_after_adamw`` with the batch's gradient)."""
    cfg, ref, port = _setup("granite-3-8b")
    pcfg = port_smoke("granite-3-8b")
    batch = _batch(cfg, batch=4)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    p_full, _, m_full = make_train_step(pcfg, TrainConfig(lr=1e-2))(
        params_from_reference(np_tree(ref), device="cpu"),
        init_opt_state(port), tb)
    micro = TrainConfig(lr=1e-2, microbatch=2)
    p_micro, _, m_micro = make_train_step(pcfg, micro)(
        port, init_opt_state(port), tb)
    np.testing.assert_allclose(float(m_full["loss"]),
                               float(m_micro["loss"]), rtol=1e-5)
    diff = max(float((a - b).abs().max()) for (_, a), (_, b) in
               zip(leaves(p_full), leaves(p_micro)))
    assert diff < 5e-3
    r_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    r_p, _, r_m = jax.jit(rts.make_train_step(cfg, micro))(
        ref, rts.init_opt_state(ref), r_batch)
    np.testing.assert_allclose(float(m_micro["loss"]), float(r_m["loss"]),
                               rtol=1e-5)
    _, r_g = jax.value_and_grad(rts.make_loss_fn(cfg, micro),
                                has_aux=True)(ref, r_batch)
    close_after_adamw(p_micro, r_p, r_g, micro.lr)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_opt_state_shapes_match_reference(optimizer):
    cfg = get_smoke_config("olmoe-1b-7b")
    tcfg = TrainConfig(optimizer=optimizer)
    ref = rts.opt_state_shapes(rlm.param_shapes(cfg), tcfg)
    port = opt_state_shapes(plm.param_shapes(port_smoke("olmoe-1b-7b")),
                            tcfg)
    p, r = leaves(port), leaves(ref)
    assert [k for k, _ in p] == [k for k, _ in r]
    for (k, a), (_, b) in zip(p, r):
        assert a.device.type == "meta", k
        assert tuple(a.shape) == tuple(b.shape), k
        assert str(a.dtype).split(".")[-1] == str(b.dtype), k


# ------------------------------------------------------------------ data ---

@pytest.mark.parametrize("emb", [0, 12])
def test_synth_batch_bitwise_equal_to_reference(emb):
    for seed, step in ((0, 0), (3, 42), (7, 123456)):
        r_cfg = rdata.DataConfig(vocab=101, batch=4, seq_len=16, seed=seed,
                                 embeddings_dim=emb)
        p_cfg = DataConfig(vocab=101, batch=4, seq_len=16, seed=seed,
                           embeddings_dim=emb)
        r, p = rdata.synth_batch(r_cfg, step), synth_batch(p_cfg, step)
        assert sorted(r) == sorted(p)
        for k in r:
            assert r[k].dtype == p[k].dtype and r[k].shape == p[k].shape
            assert r[k].tobytes() == p[k].tobytes(), k


def test_prefetcher_delivers_in_order():
    cfg = DataConfig(vocab=50, batch=2, seq_len=8, seed=0)
    pf = Prefetcher(cfg, start_step=5, depth=2)
    try:
        for step in (5, 6, 7):
            got = next(iter(pf))
            np.testing.assert_array_equal(got["tokens"],
                                          synth_batch(cfg, step)["tokens"])
    finally:
        pf.close()
    assert not pf._thread.is_alive()


# ----------------------------------------------------------- checkpoints ---

@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_reference_checkpoint_trains_on_in_the_port(tmp_path, optimizer):
    """A checkpoint the reference writes after one step loads through the
    port's ``load_train_state`` and ``opt_state_from_reference``; one
    more port step matches one more reference step (loss rtol=1e-5,
    parameters atol=1e-5 * max|p|)."""
    cfg, ref, _ = _setup("starcoder2-3b")
    tcfg = TrainConfig(optimizer=optimizer, lr=1e-3)
    step_fn = jax.jit(rts.make_train_step(cfg, tcfg))
    b0, b1 = (_batch(cfg, step=s) for s in (0, 1))
    r_p, r_o, _ = step_fn(ref, rts.init_opt_state(ref, tcfg),
                          {k: jnp.asarray(v) for k, v in b0.items()})
    path = str(tmp_path / "ref.npz")
    rck.save_train_state(path, 1, r_p, r_o, {"note": "ref"})
    step, hp, ho, meta = load_train_state(path)
    assert step == 1 and meta == {"note": "ref"}
    params = params_from_reference(hp, device="cpu")
    opt = opt_state_from_reference(ho, device="cpu")
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 1
    r_p2, _, r_m2 = step_fn(r_p, r_o,
                            {k: jnp.asarray(v) for k, v in b1.items()})
    p_p2, _, p_m2 = make_train_step(port_smoke("starcoder2-3b"), tcfg)(
        params, opt, {k: torch.as_tensor(v) for k, v in b1.items()})
    np.testing.assert_allclose(float(p_m2["loss"]), float(r_m2["loss"]),
                               rtol=1e-5)
    close_tree(p_p2, r_p2, 0.0, 1e-5)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    """The port's file holds the reference's keys and arrays (f32 and
    int32 equal; a bf16 leaf as the reference stores one, ``V2``), and
    reloads in the port bit for bit."""
    params = {"layers": {"w": torch.randn(2, 3)},
              "embed": torch.randn(4, 2).to(torch.bfloat16)}
    opt = adamw_init(params)
    path = str(tmp_path / "port.npz")
    save_train_state(path, 7, params, opt, {"note": "port"})
    step, hp, ho, meta = rck.load_train_state(path)
    assert step == 7 and meta == {"note": "port"}
    np.testing.assert_array_equal(hp["layers"]["w"],
                                  params["layers"]["w"].numpy())
    assert int(ho["step"]) == 0 and ho["step"].dtype == np.int32
    ref_bf16 = np.asarray(jnp.asarray(params["embed"].float().numpy(),
                                      jnp.bfloat16))
    assert hp["embed"].dtype == np.dtype("V2")
    assert hp["embed"].tobytes() == ref_bf16.tobytes()
    _, hp2, ho2, _ = load_train_state(path)
    back = params_from_reference(hp2, device="cpu")
    assert back["embed"].dtype == torch.bfloat16
    assert torch.equal(back["embed"], params["embed"])
    assert torch.equal(back["layers"]["w"], params["layers"]["w"])
    assert opt_state_from_reference(ho2, device="cpu")["m"]["embed"].dtype \
        == torch.float32


class _GridRank:
    """A rank of a (data=2, model=2) mesh without a process group:
    what ``local_block`` reads of a mesh."""

    axis_names = ("data", "model")
    shape = {"data": 2, "model": 2}
    device = torch.device("cpu")

    def __init__(self, data, model):
        self.coords = {"data": data, "model": model}

    def size(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes):
        axes = (axes,) if isinstance(axes, str) else axes
        idx = 0
        for a in self.axis_names:
            if a in axes:
                idx = idx * self.shape[a] + self.coords[a]
        return idx


def test_place_cuts_each_ranks_block():
    """Every rank's blocks of every leaf under ``partition_specs`` (the
    "pod" axis dropped: a single-pod mesh) tile the whole leaf."""
    cfg = port_smoke("granite-3-8b")
    params = plm.init_params(cfg, device="cpu")
    specs = plm.partition_specs(cfg)

    def drop_pod(spec):
        if isinstance(spec, dict):
            return {k: drop_pod(v) for k, v in spec.items()}
        return tuple(tuple(a for a in s if a != "pod") or None
                     if isinstance(s, tuple) else s for s in spec)

    specs = drop_pod(specs)
    blocks = {(d, m): place(params, _GridRank(d, m), specs)
              for d in range(2) for m in range(2)}
    spec_of = dict(_spec_leaves(specs))
    for path, whole in leaves(params):
        parts = [dict(leaves(b))[path] for b in blocks.values()]
        split = math.prod(_GridRank(0, 0).size(a) for a in spec_of[path]
                          if a is not None)
        # each block is 1/split of the leaf, held by 4/split ranks
        assert all(p.numel() * split == whole.numel() for p in parts), path
        assert all(p.dtype == whole.dtype for p in parts), path
    w = params["layers"]["mixer"]["wq"]          # (L, d, H*dh): (None,
    got = blocks[(1, 0)]["layers"]["mixer"]["wq"]  # "data", "model")
    L, d, f = w.shape
    assert torch.equal(got, w[:, d // 2:, :f // 2])


def _spec_leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _spec_leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


# ---------------------------------------------------------------- launch ---

def test_end_to_end_training_loss_decreases():
    """The reference test's run: the loss drops by more than 0.5."""
    from repro_torch.launch import train as train_mod

    losses = train_mod.main([
        "--arch", "starcoder2-3b", "--smoke", "--steps", "60",
        "--batch", "4", "--seq", "32", "--lr", "1e-2", "--log-every", "30",
        "--device", "cpu",
    ])
    assert len(losses) == 60
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])


def test_train_resume_from_checkpoint(tmp_path):
    from repro_torch.launch import train as train_mod

    ckpt = str(tmp_path / "ck")
    common = ["--arch", "rwkv6-1.6b", "--smoke", "--batch", "2", "--seq",
              "16", "--ckpt-dir", ckpt, "--ckpt-every", "10",
              "--log-every", "10", "--device", "cpu"]
    l1 = train_mod.main(common + ["--steps", "20"])
    l2 = train_mod.main(common + ["--steps", "30", "--resume"])
    assert len(l1) == 20
    assert len(l2) == 10          # resumed at step 20, ran to 30
    # the resumed run continues the first: ten more steps from scratch
    # with the same data give what steps 21-30 would
    l3 = train_mod.main([a for a in common if a != ckpt and a != "--ckpt-dir"]
                        + ["--steps", "30"])
    np.testing.assert_allclose(l2, l3[20:], rtol=1e-5)


def test_train_lm_example_tiny():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", "torch_train_lm.py"),
         "--tiny", "--device", "cpu", "--steps", "20"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "model lm-tiny:" in out.stdout
    assert "  step   20: loss" in out.stdout
    assert "(improved)" in out.stdout, out.stdout
