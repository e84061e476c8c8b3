"""The port's sharded PDHG (``repro_torch.distributed.pdhg_dist``) against
the reference's ``solve_dist``.

One rank runs in this process (a 1x1 mesh with no process group); the
2x2 and (2, 1, 2) meshes run as four gloo ranks on the CPU, spawned once
for the module (``_torch_dist_harness``).  The reference's draws (its
``PRNGKey(seed + 1)`` split, full normal vectors; the Lanczos start of
``PRNGKey(0)``) are made here with JAX and injected into the port.
"""
import os

import numpy as np
import pytest
import torch
from _torch_dist_harness import run_ranks
from _torch_parity import port_options, reference

OPTS = dict(max_iters=20000, tol=1e-6, check_every=64)
LP = (24, 40, 11)
# name: (mesh shape, axes, instance, options); every mesh is 4 ranks
CASES = {
    "grid": ((2, 2), ("data", "model"), LP, OPTS),
    "pods": ((2, 1, 2), ("pod", "data", "model"), LP, OPTS),
    "padded": ((2, 2), ("data", "model"), (21, 37, 3), OPTS),
    "adaptive": ((2, 2), ("data", "model"), LP,
                 dict(OPTS, step_rule="adaptive")),
}


def _ref_lp(spec):
    from repro.lp import random_standard_lp

    m, n, seed = spec
    return random_standard_lp(m, n, seed=seed)


def reference_dist_draws(lp, opts):
    """The draws of the reference's ``solve_dist`` on a one-device mesh:
    ``key, kx, ky = split(PRNGKey(seed + 1), 3)``, the full normal x0
    (n,) and y0 (m,), and the Lanczos start ``normal(PRNGKey(0),
    (m + n,))``."""
    import jax
    import jax.numpy as jnp

    from repro_torch.interop import Draws

    m, n = lp.K.shape
    _, kx, ky = jax.random.split(jax.random.PRNGKey(opts.seed + 1), 3)
    return Draws(np.asarray(jax.random.normal(kx, (n,), jnp.float64)),
                 np.asarray(jax.random.normal(ky, (m,), jnp.float64)),
                 np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                              (m + n,), jnp.float64)))


def reference_dist(lp, opts, tile_dtype=None):
    """The reference's ``solve_dist`` on its one-device mesh."""
    from repro.distributed.pdhg_dist import solve_dist
    from repro.launch.mesh import make_mesh

    return solve_dist(lp, make_mesh((1, 1), ("data", "model")), opts,
                      tile_dtype=tile_dtype)


def port_dist(lp, ref_opts, tile_dtype=None, **overrides):
    """The port's ``solve_dist`` on one rank (no process group), with the
    reference's draws injected."""
    from repro_torch.distributed import solve_dist
    from repro_torch.interop import from_reference_lp
    from repro_torch.runtime.mesh import make_mesh

    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    return solve_dist(from_reference_lp(lp), mesh,
                      port_options(ref_opts, **overrides),
                      tile_dtype=tile_dtype,
                      draws=reference_dist_draws(lp, ref_opts))


@pytest.fixture(scope="module")
def ref_pdhg(x64_module):
    _, pdhg = reference()
    return pdhg


@pytest.fixture(scope="module")
def x64_module():
    import jax

    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("rule", ["fixed", "adaptive"])
def test_one_rank_matches_reference(ref_pdhg, rule):
    """A 1x1 mesh: the same status and iterations as the reference's
    one-device ``solve_dist``, x and y within 1e-10."""
    lp = _ref_lp(LP)
    opts = ref_pdhg.PDHGOptions(**dict(OPTS, step_rule=rule))
    ref = reference_dist(lp, opts)
    port = port_dist(lp, opts)
    assert ref.status == "optimal"
    assert (port.status, port.iterations, port.mvm_calls) == \
        (ref.status, ref.iterations, ref.mvm_calls)
    np.testing.assert_allclose(port.x, ref.x, rtol=0, atol=1e-10)
    np.testing.assert_allclose(port.y, ref.y, rtol=0, atol=1e-10)
    np.testing.assert_allclose(port.sigma_max, ref.sigma_max, rtol=1e-12)
    np.testing.assert_allclose(port.merit, ref.merit, rtol=1e-8)


def test_step_forms_equal_plain_updates(ref_pdhg):
    """The reference hardwires its plain updates in ``solve_dist``; the
    port runs the update kernels' step forms, whose plain versions on
    CPU tensors give the plain updates' bits."""
    lp = _ref_lp(LP)
    opts = ref_pdhg.PDHGOptions(**OPTS)
    a = port_dist(lp, opts, kernel="cuda")
    b = port_dist(lp, opts, kernel="torch")
    assert a.iterations == b.iterations
    assert np.array_equal(a.x, b.x) and np.array_equal(a.y, b.y)


def test_bf16_tiles_match_reference(ref_pdhg):
    """bf16 tiles with f32 accumulation: one window within 1e-5 of the
    reference's (the sums' order differs).  Rounding each product's
    operand to bf16 acts as a read noise of about 2^-9, so neither
    solve reaches tol=1e-3 and the two drift apart after the first
    restart: a whole budget ends on the same status and iterations, each
    objective within 5e-3 of the known optimum."""
    import jax.numpy as jnp

    lp = _ref_lp(LP)
    short = ref_pdhg.PDHGOptions(max_iters=64, tol=0.0, check_every=64)
    ref = reference_dist(lp, short, tile_dtype=jnp.bfloat16)
    port = port_dist(lp, short, tile_dtype=torch.bfloat16)
    np.testing.assert_allclose(port.x, ref.x, rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.y, ref.y, rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.sigma_max, ref.sigma_max, rtol=1e-12)
    full = ref_pdhg.PDHGOptions(max_iters=2000, tol=1e-3, check_every=64)
    ref = reference_dist(lp, full, tile_dtype=jnp.bfloat16)
    port = port_dist(lp, full, tile_dtype=torch.bfloat16)
    assert (port.status, port.iterations) == (ref.status, ref.iterations)
    for r in (port, ref):
        assert abs(r.obj - lp.obj_opt) <= 5e-3 * abs(lp.obj_opt)


def test_residual_components_are_real(ref_pdhg):
    """The result's residuals are the four components of the unscaled
    solution, as a dense ``kkt_residuals`` gives them."""
    from repro_torch.core.residuals import kkt_residuals

    lp = _ref_lp(LP)
    r = port_dist(lp, ref_pdhg.PDHGOptions(**OPTS))
    got = r.residuals.as_dict()
    assert len({f"{v:.12e}" for v in got.values()}) > 1, got

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    want = kkt_residuals(t(r.x), t(r.x), t(r.y), t(lp.c), t(lp.b),
                         t(lp.K @ r.x), t(lp.K.T @ r.y), lb=t(lp.lb),
                         ub=t(lp.ub)).as_dict()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
    assert r.status == "optimal" and float(r.residuals.max) < 10 * OPTS["tol"]


def test_solve_dist_auto_single_process_fallback(ref_pdhg):
    """``solve_dist_auto`` without a cluster is the local mesh of one
    rank: ``solve_dist`` on 1x1."""
    from repro_torch.core.pdhg import PDHGOptions
    from repro_torch.distributed import solve_dist_auto
    from repro_torch.lp import random_standard_lp
    from repro_torch.runtime import cluster

    cluster._reset_for_tests()
    try:
        lp = random_standard_lp(10, 18, seed=0)
        r = solve_dist_auto(lp, PDHGOptions(**OPTS), cluster="off",
                            device="cpu")
        assert r.status == "optimal"
        assert abs(r.obj - lp.obj_opt) / abs(lp.obj_opt) < 1e-4
    finally:
        cluster._reset_for_tests()


def test_make_dist_step_one_rank_equals_engine_steps():
    """``make_dist_step`` on a 1x1 mesh is ``engine.pdhg_step`` on the
    dense operator, bit for bit."""
    from repro_torch.core import engine
    from repro_torch.core.pdhg import PDHGOptions, prepare
    from repro_torch.distributed import make_dist_step, shard_problem
    from repro_torch.lp import random_standard_lp
    from repro_torch.runtime.mesh import make_mesh

    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    scaled, T, Sigma = prepare(random_standard_lp(12, 20, seed=7),
                               PDHGOptions(), "cpu")
    prob = shard_problem(scaled, T, Sigma, mesh)
    g = torch.Generator().manual_seed(3)
    x = torch.clamp(torch.randn(20, generator=g, dtype=torch.float64),
                    prob.lb, prob.ub)
    y = torch.randn(12, generator=g, dtype=torch.float64)
    tau = torch.tensor(0.2, dtype=torch.float64)
    out = make_dist_step(mesh, n_inner=5)(
        prob.K, prob.b, prob.c, prob.lb, prob.ub, prob.T, prob.Sigma,
        x, x, y, tau, tau)
    op = engine.dense_operator(scaled.K, scaled.K.mT)
    s = engine.PDHGState(x=x, x_prev=x, x_bar=x, y=y, tau=tau, sigma=tau)
    for _ in range(5):
        s = engine.pdhg_step(op, engine.CUDA_UPDATES, scaled.b, scaled.c,
                             scaled.lb, scaled.ub, T, Sigma, 0.0, s)
    for a, b in zip(out, (s.x, s.x_bar, s.y, s.tau, s.sigma)):
        assert torch.equal(a, b)


# ------------------------------------------------ four gloo ranks, CPU ---

@pytest.fixture(scope="module")
def four_ranks(ref_pdhg, tmp_path_factory):
    """Every case of ``CASES`` on four spawned ranks (one spawn), with
    the reference's draws; and the reference's one-device results."""
    d = str(tmp_path_factory.mktemp("dist4"))
    refs, cases = {}, []
    for name, (shape, axes, spec, opts) in CASES.items():
        lp = _ref_lp(spec)
        o = ref_pdhg.PDHGOptions(**opts)
        refs[name] = reference_dist(lp, o)
        dr = reference_dist_draws(lp, o)
        np.savez(os.path.join(d, f"{name}.npz"), x0=dr.x0, y0=dr.y0,
                 v0=dr.v0)
        cases.append({"name": name, "shape": list(shape), "axes": list(axes),
                      "lp": list(spec), "opts": opts, "draws": name})
    ranks = run_ranks(4, "solve", {"cases": cases}, d, timeout=300)
    return refs, ranks


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_match_reference(four_ranks, name):
    """2x2, (2, 1, 2) with a pod axis, a shape the mesh does not divide
    (padding) and the adaptive rule through the all-reduced hooks: the
    reference's one-device iterations and status, x within 1e-8; every
    rank returns the same whole result."""
    refs, ranks = four_ranks
    ref, r0 = refs[name], ranks[0]
    assert str(r0[f"{name}/status"]) == ref.status == "optimal"
    assert int(r0[f"{name}/iterations"]) == ref.iterations
    np.testing.assert_allclose(r0[f"{name}/x"], ref.x, rtol=0, atol=1e-8)
    np.testing.assert_allclose(r0[f"{name}/y"], ref.y, rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(r0[f"{name}/sigma_max"]),
                               ref.sigma_max, rtol=1e-12)
    for r in ranks[1:]:
        for k in r0:
            if k.startswith(name + "/"):
                assert np.array_equal(r[k], r0[k]), k


@pytest.mark.parametrize("name", list(CASES))
def test_four_ranks_collective_count(four_ranks, name):
    """Every collective is explicit: two all-reduces a step, eight a
    check (the products and merits of the iterate and of the average),
    one for the norm and two gathers; the adaptive rule adds two at the
    start and six a check."""
    _, ranks = four_ranks
    it = int(ranks[0][f"{name}/iterations"])
    windows = it // CASES[name][3]["check_every"]
    want = 2 * it + 8 * windows + 3
    if CASES[name][3].get("step_rule") == "adaptive":
        want += 2 + 6 * windows
    assert int(ranks[0][f"{name}/all_reduce"]) == want
