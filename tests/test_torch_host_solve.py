"""The port's host driver ``pdhg.solve`` (Algorithm 4 over an ``Accel``)
against the reference's, f64 on the CPU with the reference's host draws
injected: on the exact backend, and on the crossbar simulation with
quantization but no programming or read noise (both ``use_kernel``
settings, every step rule x restart).  Noisy backends are held to the
reference's statistics and bands."""
import dataclasses
import functools

import numpy as np
import pytest
import torch
from _torch_parity import (
    RULES,
    assert_ledgers_equal,
    noiseless_device,
    port_options,
    reference,
    reference_host_draws,
)

from repro_torch.core import pdhg as tp
from repro_torch.core.lanczos import lanczos_svd
from repro_torch.core.noise import NoiseModel
from repro_torch.core.symblock import encode_exact
from repro_torch.crossbar import TAOX_HFOX, crossbar_accel_factory
from repro_torch.interop import device_from_reference, from_reference_lp
from repro_torch.lp import random_standard_lp, table1_instance
from repro_torch.lp.generators import infeasible_lp

INSTANCES = {"rand12x20": lambda: random_standard_lp(12, 20, seed=1),
             "gen-ip002": lambda: table1_instance("gen-ip002")}
# short solves: the reference's host loop is eager JAX, about 10 ms a
# step; 400 steps with a check every 50 still restart several times
BASE = dict(max_iters=400, tol=1e-9, check_every=50, lanczos_iters=24)


@functools.lru_cache(maxsize=None)
def _reference(name, crossbar, use_kernel=False, **kw):
    """(options, result, ledger) of the reference's host solve; cached
    so the port's two ``use_kernel`` settings share one reference run."""
    import jax

    jax.config.update("jax_enable_x64", True)
    _, pdhg = reference()
    from repro.crossbar import TAOX_HFOX as REF_TAOX
    from repro.crossbar.array import crossbar_accel_factory as ref_factory

    opts = pdhg.PDHGOptions(**{**BASE, **kw})
    fac = (ref_factory(device=noiseless_device(REF_TAOX),
                       use_kernel=use_kernel) if crossbar else None)
    res = pdhg.solve(INSTANCES[name](), opts, accel_factory=fac)
    return opts, res, None if fac is None else fac.ledger


def _port(name, ref_opts, factory=None, **overrides):
    lp = INSTANCES[name]()
    return tp.solve(from_reference_lp(lp), port_options(ref_opts, **overrides),
                    accel_factory=factory, device="cpu",
                    draws=reference_host_draws(lp, ref_opts))


def assert_host_matches(port, ref, atol=1e-10):
    assert port.status == ref.status
    assert port.iterations == ref.iterations
    assert port.mvm_calls == ref.mvm_calls
    assert port.lanczos_iters == ref.lanczos_iters
    assert port.restarts == ref.restarts
    np.testing.assert_allclose(port.x, ref.x, rtol=0, atol=atol)
    np.testing.assert_allclose(port.y, ref.y, rtol=0, atol=atol)
    np.testing.assert_allclose(port.sigma_max, ref.sigma_max, rtol=1e-12)
    np.testing.assert_allclose(port.merit, ref.merit, rtol=1e-8, atol=1e-14)


@pytest.mark.parametrize("name", list(INSTANCES))
def test_host_solve_exact_backend_matches_reference(x64, name):
    ref_opts, ref, _ = _reference(name, crossbar=False)
    assert ref.restarts > 0
    assert_host_matches(_port(name, ref_opts), ref)
    assert_host_matches(_port(name, ref_opts, kernel="cuda"), ref)


@pytest.mark.parametrize("restart", [True, False], ids=["restart", "norestart"])
@pytest.mark.parametrize("rule", list(RULES))
def test_host_solve_crossbar_matches_reference(x64, rule, restart):
    ref_opts, ref, ref_led = _reference(
        "rand12x20", crossbar=True, step_rule=rule, gamma=RULES[rule],
        restart=restart)
    from repro.crossbar import TAOX_HFOX as REF_TAOX

    dev = device_from_reference(noiseless_device(REF_TAOX))
    for use_kernel in (False, True):
        fac = crossbar_accel_factory(device=dev, use_kernel=use_kernel)
        port = _port("rand12x20", ref_opts, fac)
        assert_host_matches(port, ref)
        assert_ledgers_equal(fac.ledger, ref_led)
        assert fac.ledger.mvm_count == port.mvm_calls


def test_host_solve_crossbar_matches_reference_kernel_path_gen_ip002(x64):
    """The reference's own B6 path (Pallas in interpret mode) against the
    port's, on the paper's instance."""
    ref_opts, ref, ref_led = _reference("gen-ip002", crossbar=True,
                                        use_kernel=True)
    fac = crossbar_accel_factory(device=noiseless_device(TAOX_HFOX),
                                 use_kernel=True)
    assert_host_matches(_port("gen-ip002", ref_opts, fac), ref)
    assert_ledgers_equal(fac.ledger, ref_led)


def test_host_lanczos_matches_reference(x64):
    """Algorithm 3 with re-orthogonalization and its early exit, on the
    same start vector."""
    import jax
    import jax.numpy as jnp

    _, _ = reference()
    from repro.core import lanczos as rl
    from repro.core import symblock as rs

    K = np.random.default_rng(0).normal(size=(9, 14))
    v0 = np.array(jax.random.normal(
        jax.random.split(jax.random.PRNGKey(3))[1], (23,)))
    ref = rl.lanczos_svd(rs.encode_exact(jnp.asarray(K)), k_max=40,
                         key=jax.random.PRNGKey(3))
    port = lanczos_svd(encode_exact(torch.from_numpy(K)), k_max=40, v0=v0)
    assert port.iterations == ref.iterations < 40      # the early exit
    np.testing.assert_allclose(port.sigma_max, ref.sigma_max, rtol=1e-12)
    np.testing.assert_allclose(port.alphas, ref.alphas, atol=1e-12)
    np.testing.assert_allclose(port.sigma_max, np.linalg.norm(K, 2),
                               rtol=1e-10)


def test_accel_modes_and_scaled_similarity():
    """Algorithm 2's modes and the preconditioning wrap, against the
    dense symmetric block (the reference's test_core checks, ported)."""
    from repro_torch.core.lanczos import power_iteration
    from repro_torch.core.symblock import (
        MODE_ATY,
        MODE_AX,
        MODE_FULL,
        as_dense,
        build_sym_block,
        matmul_accel,
        scaled_accel,
    )

    rng = np.random.default_rng(1)
    K = torch.from_numpy(rng.normal(size=(5, 7)))
    acc = encode_exact(K)
    M = build_sym_block(K).numpy()
    np.testing.assert_array_equal(as_dense(acc), M)
    x, y = torch.from_numpy(rng.normal(size=7)), torch.from_numpy(
        rng.normal(size=5))
    torch.testing.assert_close(matmul_accel(acc, x, MODE_AX), K @ x)
    torch.testing.assert_close(matmul_accel(acc, y, MODE_ATY), K.T @ y)
    u = torch.cat([y, x])
    torch.testing.assert_close(matmul_accel(acc, u, MODE_FULL),
                               torch.from_numpy(M) @ u)
    assert acc.stats["mvm_calls"] == 3     # as_dense probes uncounted
    r, c = torch.rand(5, dtype=torch.float64), torch.rand(
        7, dtype=torch.float64)
    d = torch.cat([r, c]).numpy()
    np.testing.assert_allclose(as_dense(scaled_accel(acc, r, c)),
                               d[:, None] * M * d[None, :], rtol=1e-14)
    with pytest.raises(ValueError, match="unknown mode"):
        matmul_accel(acc, x, "sideways")
    np.testing.assert_allclose(float(power_iteration(K, iters=200)),
                               np.linalg.norm(K.numpy(), 2), rtol=1e-8)


def test_theory_copies_match_reference():
    """The numpy-only theory module is a copy: same answers."""
    reference()
    from repro.core import theory as rt

    from repro_torch.core import theory as tt

    assert (dataclasses.asdict(tt.safe_coupling(2.0, 0.1))
            == dataclasses.asdict(rt.safe_coupling(2.0, 0.1)))
    assert tt.lemma2_worst_case(1.0, 1.05, 0.4, 0.4, 0.1) == \
        rt.lemma2_worst_case(1.0, 1.05, 0.4, 0.4, 0.1)
    k = np.arange(1, 6)
    np.testing.assert_array_equal(tt.theorem1_envelope(k, 2.0, 0.5, 2, 1e-3),
                                  rt.theorem1_envelope(k, 2.0, 0.5, 2, 1e-3))
    eigs = np.array([3.0, -3.0, 1.0, 0.5])
    assert tt.spectral_ratio(eigs) == rt.spectral_ratio(eigs)


def test_host_solve_noisy_backend_converges():
    """The reference's noisy-backend band (test_system), on the port's
    generator-driven multiplicative noise."""
    lp = random_standard_lp(16, 28, seed=0)
    opts = tp.PDHGOptions(max_iters=6000, tol=1e-4, check_every=100)
    noise = NoiseModel("multiplicative", 1e-3)
    a = tp.solve(lp, opts, noise=noise, device="cpu")
    b = tp.solve(lp, opts, noise=noise, device="cpu")
    np.testing.assert_array_equal(a.x, b.x)            # seeded
    assert abs(a.obj - lp.obj_opt) / abs(lp.obj_opt) < 2e-2
    assert a.mvm_calls > 2 * a.iterations


@pytest.mark.parametrize("kind", ["multiplicative", "additive"])
def test_noise_model_draws_unit_mean_truncated_noise(kind):
    g = torch.Generator().manual_seed(0)
    w = torch.full((200_000,), 2.0, dtype=torch.float64)
    noisy = NoiseModel(kind, 0.05).apply(g, w)
    z = (noisy / w - 1.0) / 0.05         # both kinds: rms(w) = w here
    assert abs(float(z.mean())) < 0.02
    assert abs(float(z.std()) - 1.0) < 0.02
    assert float(z.abs().max()) <= 4.0 + 1e-9
    assert NoiseModel().apply(g, w) is w


def test_host_solve_crossbar_reaches_the_paper_band():
    """test_system's crossbar host loop, ported: TaOx-HfOx with its
    programming and read noise, within the paper's Table-2 gap band."""
    lp = random_standard_lp(12, 20, seed=1)
    fac = crossbar_accel_factory(device=TAOX_HFOX, use_kernel=True)
    r = tp.solve(lp, tp.PDHGOptions(max_iters=6000, tol=1e-4,
                                    check_every=100, lanczos_iters=24),
                 accel_factory=fac, device="cpu")
    assert abs(r.obj - lp.obj_opt) / abs(lp.obj_opt) < 5e-2
    led = fac.ledger
    assert led.mvm_count == r.mvm_calls
    assert led.write_energy_j > 0 and led.read_energy_j > 0


def test_host_solve_history_callback_and_accounting():
    lp = random_standard_lp(8, 14, seed=1)
    seen = []
    opts = tp.PDHGOptions(max_iters=20000, tol=1e-6, check_every=64,
                          track_history=True)
    r = tp.solve(lp, opts, device="cpu",
                 on_iteration=lambda it, merit, acc: seen.append(it))
    assert r.status == "optimal"
    assert seen == [h["iter"] for h in r.history] == list(
        range(64, r.iterations + 1, 64))
    assert r.history[-1]["merit"] <= opts.tol
    # 2 MVMs a step, 4 a check, less the converging check's averaged pair
    n_checks = r.iterations // opts.check_every
    assert r.mvm_calls == r.lanczos_iters + 2 * r.iterations + 4 * n_checks - 2


def test_host_solve_blown_up_reports_diverged():
    lp = random_standard_lp(8, 14, seed=0)
    r = tp.solve(lp, tp.PDHGOptions(max_iters=256, tol=1e-6, check_every=64,
                                    norm_override=1e-12), device="cpu")
    assert not np.isfinite(r.merit)
    assert r.status == "diverged" and r.iterations == 64


def test_host_solve_certifies_infeasibility():
    """On divergence the driver attaches a verified Farkas certificate
    when the dual ray is one (the reference's behaviour, ported)."""
    from repro_torch.core.infeasibility import check_farkas

    lp = infeasible_lp(8, 12, seed=7)
    r = tp.solve(lp, tp.PDHGOptions(max_iters=8000, tol=1e-9,
                                    check_every=100, restart=False),
                 device="cpu")
    assert r.status in ("primal_infeasible", "diverged", "iteration_limit")
    if r.status == "primal_infeasible":
        cert = check_farkas(lp.K, lp.b, r.certificate.y_ray)
        assert cert.kind == "primal_infeasible"


def test_host_solve_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.solve(random_standard_lp(4, 6, seed=0))
