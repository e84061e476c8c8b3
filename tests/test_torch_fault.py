"""Fault tolerance of the port (``repro_torch.distributed.fault``):
atomic checkpoints, rotation, bit-deterministic restore, and an elastic
restore from a 2x2 mesh onto a 1x2 one (gloo ranks on the CPU) that
continues the same iterate stream; ``make_dist_step`` held against the
reference's on one rank."""
import glob
import os

import numpy as np
import pytest
import torch
from _torch_dist_harness import run_ranks

from repro_torch.core.pdhg import PDHGOptions, prepare
from repro_torch.distributed import (
    CheckpointManager,
    load_checkpoint,
    make_dist_step,
    named_sharding,
    reshard,
    save_checkpoint,
    shard_problem,
)
from repro_torch.lp import random_standard_lp
from repro_torch.runtime.mesh import make_mesh

STEP_OPTS = PDHGOptions(max_iters=64, tol=1e-30, check_every=64,
                        ruiz_iters=4, lanczos_iters=8)
SPECS = {"x": ("model",), "x_bar": ("model",), "y": ("data",)}


def test_checkpoint_atomicity_and_roundtrip(tmp_path):
    path = str(tmp_path / "ck.npz")
    arrays = {"x": torch.arange(10.0, dtype=torch.float64),
              "nested/w": np.ones((3, 4))}
    save_checkpoint(path, 7, arrays, {"tag": "t"})
    ck = load_checkpoint(path)
    assert ck.step == 7 and ck.meta["tag"] == "t"
    np.testing.assert_array_equal(ck.arrays["x"], np.arange(10.0))
    np.testing.assert_array_equal(ck.arrays["nested/w"], np.ones((3, 4)))
    save_checkpoint(path, 8, arrays)
    assert load_checkpoint(path).step == 8


def test_crash_mid_write_preserves_last_good_checkpoint(tmp_path,
                                                        monkeypatch):
    """A crash between the temp write and the rename leaves the previous
    snapshot loadable and no temp file behind."""
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, 1, {"x": np.arange(4.0)}, {"tag": "good"})

    def dying_replace(src, dst):
        raise OSError("simulated crash before rename")

    monkeypatch.setattr(os, "replace", dying_replace)
    with pytest.raises(OSError, match="simulated crash"):
        save_checkpoint(path, 2, {"x": np.zeros(4)}, {"tag": "bad"})
    monkeypatch.undo()
    ck = load_checkpoint(path)
    assert ck.step == 1 and ck.meta["tag"] == "good"
    np.testing.assert_array_equal(ck.arrays["x"], np.arange(4.0))
    assert glob.glob(str(tmp_path / "*.tmp")) == []


def test_manager_rotation_and_torn_temp_file(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, every=10)
    for step in range(1, 51):
        mgr.maybe_save(step, {"a": np.zeros(2)})
    assert len(os.listdir(tmp_path)) == 2
    assert mgr.latest().endswith("ckpt_000000000050.npz")
    with open(tmp_path / "tmpXXXX.tmp", "wb") as f:
        f.write(b"PK\x03\x04 torn")
    assert mgr.latest().endswith("ckpt_000000000050.npz")


def test_reshard_cuts_each_rank_block():
    mesh = make_mesh({"data": 1, "model": 1}, device="cpu")
    w = np.arange(32.0).reshape(8, 4)
    placed = reshard({"w": w, "s": np.float64(3.0)}, mesh,
                     {"w": named_sharding(mesh, "data", None)})
    assert torch.equal(placed["w"], torch.as_tensor(w))
    assert float(placed["s"]) == 3.0


def _state(lp, mesh):
    scaled, T, Sigma = prepare(lp, STEP_OPTS, "cpu")
    prob = shard_problem(scaled, T, Sigma, mesh)
    g = torch.Generator().manual_seed(3)
    x0 = torch.clamp(torch.randn(prob.n_pad, generator=g,
                                 dtype=torch.float64), prob.lb, prob.ub)
    y0 = torch.randn(prob.m_pad, generator=g, dtype=torch.float64)
    tau = torch.tensor(0.01, dtype=torch.float64)
    return prob, (x0, x0, y0, tau, tau)


def _run(step, prob, state, k):
    for _ in range(k):
        state = step(prob.K, prob.b, prob.c, prob.lb, prob.ub, prob.T,
                     prob.Sigma, *state)
    return state


def _arrays(state):
    return dict(zip(("x", "x_bar", "y", "tau", "sigma"), state))


def test_restore_reproduces_exact_iterate_stream(tmp_path):
    """Snapshot at step 3 of 6, restore onto a fresh mesh: the remaining
    iterates are bitwise those of the uninterrupted stream."""
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    lp = random_standard_lp(12, 20, seed=7)
    step = make_dist_step(mesh, n_inner=1)
    prob, state0 = _state(lp, mesh)
    mid = _run(step, prob, state0, 3)
    path = str(tmp_path / "mid.npz")
    save_checkpoint(path, 3, _arrays(mid))
    uninterrupted = _run(step, prob, mid, 3)
    mesh2 = make_mesh((1, 1), ("data", "model"), device="cpu")
    prob2, _ = _state(lp, mesh2)
    placed = reshard(load_checkpoint(path).arrays, mesh2, SPECS)
    restored = _run(make_dist_step(mesh2, n_inner=1), prob2,
                    tuple(placed[k] for k in ("x", "x_bar", "y", "tau",
                                              "sigma")), 3)
    for name, a, b in zip(_arrays(mid), uninterrupted, restored):
        assert torch.equal(a, b), name


def test_make_dist_step_matches_reference(x64):
    """Six steps of the port's ``make_dist_step`` from the reference's
    sharded start equal the reference's within 1e-12."""
    import jax.numpy as jnp

    from repro.core import PDHGOptions as RefOptions
    from repro.core import pdhg as ref_pdhg
    from repro.distributed import make_dist_step as ref_step
    from repro.distributed import shard_problem as ref_shard
    from repro.launch.mesh import make_mesh as ref_mesh
    from repro.lp import random_standard_lp as ref_lp

    lp = ref_lp(12, 20, seed=7)
    rm = ref_mesh((1, 1), ("data", "model"))
    scaled, T, Sigma = ref_pdhg.prepare(lp, RefOptions(ruiz_iters=4))
    rp = ref_shard(scaled, T, Sigma, rm)
    g = np.random.default_rng(5)
    x0 = np.clip(g.normal(size=20), np.asarray(rp.lb), np.asarray(rp.ub))
    y0 = g.normal(size=12)
    state = (jnp.asarray(x0), jnp.asarray(x0), jnp.asarray(y0),
             jnp.asarray(0.05), jnp.asarray(0.05))
    f = ref_step(rm, n_inner=6)
    ref = f(rp.K, rp.b, rp.c, rp.lb, rp.ub, rp.T, rp.Sigma, *state)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    prob = shard_problem(*prepare(random_standard_lp(12, 20, seed=7),
                                  PDHGOptions(ruiz_iters=4), "cpu"), mesh)
    port = make_dist_step(mesh, n_inner=6)(
        prob.K, prob.b, prob.c, prob.lb, prob.ub, prob.T, prob.Sigma,
        *(torch.as_tensor(np.array(s)) for s in state))
    for name, a, b in zip(("x", "x_bar", "y", "tau", "sigma"), port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-12, err_msg=name)


def test_elastic_restore_2x2_onto_1x2(tmp_path):
    """Four gloo ranks (2x2) run 3 steps, checkpoint the gathered state
    and run 3 more; two fresh ranks (1x2, the survivors after losing a
    row of the grid) restore the checkpoint through ``reshard`` and run
    the same 3: the continued iterates equal the uninterrupted ones to
    f64 round-off (the row sums are grouped differently)."""
    d = str(tmp_path)
    args = {"lp": [16, 32, 9], "opts": {"ruiz_iters": 4}, "steps": 6,
            "save_at": 3, "shape": [2, 2]}
    big = run_ranks(4, "elastic", args, d, timeout=180)
    assert load_checkpoint(os.path.join(d, "mid.npz")).meta["mesh"] == \
        [2, 2]
    small = run_ranks(2, "elastic",
                      dict(args, shape=[1, 2], steps=3, save_at=None,
                           restore=os.path.join(d, "mid.npz")),
                      os.path.join(d, "small"), timeout=180)
    for k in ("x", "x_bar", "y", "tau", "sigma"):
        for r in big[1:]:
            assert np.array_equal(r[k], big[0][k]), k
        for r in small:
            np.testing.assert_allclose(r[k], big[0][k], rtol=1e-12,
                                       atol=1e-12, err_msg=k)
