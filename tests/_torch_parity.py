"""Helpers for the port's parity tests: run the JAX reference, and hand
its random draws to the PyTorch port (torch cannot reproduce threefry
streams, so the port takes the reference's vectors as inputs)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

# the reference's update-backend names and the port's counterparts
KERNEL_NAMES = {"jnp": "torch", "pallas": "cuda"}


def reference():
    """The reference modules, or a skip where JAX is not installed."""
    pytest.importorskip("jax")
    from repro.core import engine, pdhg

    return engine, pdhg


def reference_draws(lp, opts):
    """The start iterate and Lanczos start vector ``solve_jit`` draws:
    ``engine.draw_init(PRNGKey(seed + 1))`` on the scaled bounds, and
    ``normal(PRNGKey(0), (m + n,))`` in f64."""
    import jax
    import jax.numpy as jnp

    from repro_torch.interop import Draws

    engine, pdhg = reference()
    scaled, _, _ = pdhg.prepare(lp, opts)
    m, n = scaled.K.shape
    _, x0, y0 = engine.draw_init(jax.random.PRNGKey(opts.seed + 1), m, n,
                                 scaled.lb, scaled.ub, scaled.b.dtype)
    v0 = jax.random.normal(jax.random.PRNGKey(0), (m + n,), jnp.float64)
    return Draws(np.asarray(x0), np.asarray(y0), np.asarray(v0))


def reference_host_draws(lp, opts):
    """The draws of the reference's host driver ``pdhg.solve``: from
    ``key = PRNGKey(opts.seed)``, ``key, sub = split(key)`` feeds the
    Lanczos start (``lanczos_svd`` splits ``sub`` once more and draws
    ``normal(sub', (m + n,))``; skipped under ``norm_override``), then
    ``key, kx, ky = split(key, 3)`` draws x0 (clipped to the scaled
    bounds) and y0 (``pdhg.py:172,194,218-221``, ``lanczos.py:62-63``).
    """
    import jax
    import jax.numpy as jnp

    from repro_torch.interop import Draws

    _, pdhg = reference()
    scaled, _, _ = pdhg.prepare(lp, opts)
    m, n = scaled.K.shape
    dt = scaled.K.dtype
    key = jax.random.PRNGKey(opts.seed)
    v0 = None
    if opts.norm_override is None:
        key, sub = jax.random.split(key)
        _, sub = jax.random.split(sub)
        v0 = np.asarray(jax.random.normal(sub, (m + n,)))
    key, kx, ky = jax.random.split(key, 3)
    x0 = jnp.clip(jax.random.normal(kx, (n,), dtype=dt), scaled.lb,
                  scaled.ub)
    y0 = jax.random.normal(ky, (m,), dtype=dt)
    return Draws(np.asarray(x0), np.asarray(y0), v0)


def noiseless_device(dev):
    """A crossbar device (either package's) with no programming or read
    noise: encoding is quantization only, deterministic on both sides."""
    return dataclasses.replace(dev, sigma_program=0.0, sigma_read=0.0)


def assert_ledgers_equal(port, ref):
    """Every ledger field: counters equal, energies and latencies to
    rtol 1e-12 (the same sums in the same order on both sides)."""
    for f in dataclasses.fields(ref):
        p, r = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(r, int):
            assert p == r, f.name
        else:
            np.testing.assert_allclose(p, r, rtol=1e-12, atol=0,
                                       err_msg=f.name)


def port_options(ref_opts, **overrides):
    """The port's ``PDHGOptions`` with the reference's field values
    (update-backend names mapped), then ``overrides``."""
    from repro_torch.core.pdhg import PDHGOptions

    fields = {f.name: getattr(ref_opts, f.name)
              for f in dataclasses.fields(PDHGOptions)}
    fields["kernel"] = KERNEL_NAMES[fields["kernel"]]
    fields.update(overrides)
    return PDHGOptions(**fields)


def reference_solve(lp, **kw):
    """``(options, result)`` of the reference's ``solve_jit``."""
    _, pdhg = reference()
    opts = pdhg.PDHGOptions(**kw)
    return opts, pdhg.solve_jit(lp, opts)


def port_solve(lp, ref_opts, **overrides):
    """The port's ``solve_jit`` on the CPU with the reference's options
    (and ``overrides``) and the reference's draws injected."""
    from repro_torch.core.pdhg import solve_jit
    from repro_torch.interop import from_reference_lp

    return solve_jit(from_reference_lp(lp),
                     port_options(ref_opts, **overrides), device="cpu",
                     draws=reference_draws(lp, ref_opts))


# the step rules and the gamma each needs (strongly_convex requires > 0)
RULES = {"fixed": 0.0, "adaptive": 0.0, "strongly_convex": 0.05}


def assert_matches(port, ref, atol=1e-10):
    """The parity contract: equal status, iterations and MVM charge; x
    and y to ``atol``; the same norm estimate and in-loop merit."""
    assert port.status == ref.status
    assert port.iterations == ref.iterations
    assert port.mvm_calls == ref.mvm_calls
    assert port.lanczos_iters == ref.lanczos_iters
    np.testing.assert_allclose(port.x, ref.x, rtol=0, atol=atol)
    np.testing.assert_allclose(port.y, ref.y, rtol=0, atol=atol)
    np.testing.assert_allclose(port.sigma_max, ref.sigma_max, rtol=1e-12)
    # the carried merit is the merit of the carried iterate, on both sides
    np.testing.assert_allclose(port.merit, ref.merit, rtol=1e-8, atol=1e-14)


def check_step_rule_case(lp, rule, restart, max_iters=3000):
    """One step rule x restart case: the reference's stepped solve
    against the port's, on the plain updates and on the kernel backend
    (its plain versions on CPU tensors) with the megakernel window when
    restarts are on."""
    from repro_torch.core.engine import mvm_accounting

    ref_opts, ref = reference_solve(lp, step_rule=rule, gamma=RULES[rule],
                                    restart=restart, max_iters=max_iters)
    assert ref.mvm_calls == mvm_accounting(
        ref.iterations, ref_opts.check_every, ref_opts.lanczos_iters,
        restart=restart)
    assert_matches(port_solve(lp, ref_opts, kernel="torch"), ref)
    assert_matches(port_solve(lp, ref_opts, kernel="cuda",
                              megakernel=restart), ref)
