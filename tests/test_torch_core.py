"""The port's numerical core against ``repro.core`` in f64: Ruiz scaling,
Pock–Chambolle diagonals, the symmetric block, the norm estimators (with
the reference's start vector injected) and the KKT residuals, to 1e-12."""
import numpy as np
import pytest
import torch

from repro_torch.core import lanczos as tl
from repro_torch.core import precondition as tp
from repro_torch.core import residuals as tr
from repro_torch.core.symblock import build_sym_block
from repro_torch.lp import assignment_lp, table1_instance

TOL = 1e-12


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    return jax, jnp


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


def _problem(seed=0, m=9, n=14):
    rng = np.random.default_rng(seed)
    K = rng.normal(size=(m, n)) * rng.uniform(0.01, 100.0, size=(m, 1))
    K[2, :] = 0.0                       # an all-zero row hits the eps guard
    lb = np.where(rng.random(n) < 0.5, 0.0, -np.inf)
    ub = np.where(rng.random(n) < 0.3, rng.uniform(1.0, 3.0, n), np.inf)
    return K, rng.normal(size=m), rng.normal(size=n), lb, ub


def test_apply_ruiz_matches_reference(x64):
    _, jnp = _jax()
    from repro.core import precondition as rp

    K, b, c, lb, ub = _problem()
    ref = rp.apply_ruiz(jnp.asarray(K), b, c, lb, ub, iters=10)
    port = tp.apply_ruiz(_t(K), _t(b), _t(c), _t(lb), _t(ub), iters=10)
    for f in ("K", "b", "c", "lb", "ub", "D1", "D2"):
        _close(getattr(port, f), getattr(ref, f))
    x = np.linspace(-1.0, 1.0, K.shape[1])
    _close(port.unscale_x(_t(x)), ref.unscale_x(jnp.asarray(x)))


def test_diagonal_precondition_matches_reference(x64):
    _, jnp = _jax()
    from repro.core import precondition as rp

    K = _problem(seed=1)[0]
    T_r, S_r = rp.diagonal_precondition(jnp.asarray(K))
    T_p, S_p = tp.diagonal_precondition(_t(K))
    _close(T_p, T_r)
    _close(S_p, S_r)


def test_build_sym_block_matches_reference(x64):
    _, jnp = _jax()
    from repro.core.symblock import build_sym_block as ref_block

    K = _problem(seed=2)[0]
    np.testing.assert_array_equal(build_sym_block(_t(K)).numpy(),
                                  np.asarray(ref_block(jnp.asarray(K))))


def _scaled_block(lp):
    """M of Sigma^1/2 K T^1/2 for a prepared instance (reference side)."""
    from repro.core.pdhg import PDHGOptions, prepare
    from repro.core.symblock import build_sym_block as ref_block

    scaled, T, S = prepare(lp, PDHGOptions())
    Keff = np.sqrt(S)[:, None] * np.asarray(scaled.K) * np.sqrt(T)[None, :]
    return np.asarray(ref_block(Keff))


# gen-ip002 has m+n = 89 > 64 iterations; assignment_lp(4) has m+n = 24,
# so the Lanczos recurrence breaks down and the beta > 1e-30 branch of
# the reference decides what is carried on
@pytest.mark.parametrize("make_lp", [lambda: table1_instance("gen-ip002"),
                                     lambda: assignment_lp(4)],
                         ids=["gen-ip002", "assignment-4"])
def test_lanczos_matches_reference_with_injected_start(x64, make_lp):
    jax, jnp = _jax()
    from repro.core import lanczos as rl

    M = _scaled_block(make_lp())
    v0 = jax.random.normal(jax.random.PRNGKey(0), (M.shape[0],), jnp.float64)
    ref = float(rl.lanczos_svd_jit(jnp.asarray(M), k_max=64))
    port = tl.lanczos_svd_jit(_t(M), k_max=64, v0=_t(v0))
    assert port.shape == () and port.dtype == torch.float64
    _close(float(port), ref)
    via_mv = tl.lanczos_svd_jit_mv(lambda v: _t(M) @ v, M.shape[0],
                                   torch.float64, k_max=64, v0=_t(v0))
    assert float(via_mv) == float(port)


def test_power_iteration_matches_reference(x64):
    jax, jnp = _jax()
    from repro.core import lanczos as rl

    M = _scaled_block(table1_instance("gen-ip002"))
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (M.shape[0],),
                                      jnp.float64))
    Mj = jnp.asarray(M)
    ref = rl.power_iteration_mv(lambda v: Mj @ v, M.shape[0], jnp.float64,
                                iters=64, v0=jnp.asarray(v0))
    port = tl.power_iteration_mv(lambda v: _t(M) @ v, M.shape[0],
                                 torch.float64, iters=64, v0=_t(v0))
    _close(float(port), float(ref))


@pytest.mark.parametrize("bounds", ["none", "mixed"])
def test_kkt_residuals_match_reference(x64, bounds):
    _, jnp = _jax()
    from repro.core import residuals as rr

    K, b, c, lb, ub = _problem(seed=4)
    rng = np.random.default_rng(5)
    x, x_prev = rng.normal(size=(2, K.shape[1]))
    y = rng.normal(size=K.shape[0])
    Kx, KTy = K @ x, K.T @ y
    kw_r = {} if bounds == "none" else {"lb": jnp.asarray(lb),
                                        "ub": jnp.asarray(ub)}
    kw_p = {} if bounds == "none" else {"lb": _t(lb), "ub": _t(ub)}
    ref = rr.kkt_residuals(*(jnp.asarray(a) for a in (x, x_prev, y, c, b,
                                                      Kx, KTy)), **kw_r)
    port = tr.kkt_residuals(*(_t(a) for a in (x, x_prev, y, c, b, Kx, KTy)),
                            **kw_p)
    for f in ("r_pri", "r_dual", "r_iter", "r_gap"):
        _close(float(getattr(port, f)), float(getattr(ref, f)))
    _close(float(port.max), float(ref.max))
    assert port.as_dict().keys() == ref.as_dict().keys()


def test_relative_error_matches_reference():
    pytest.importorskip("jax")
    from repro.core.residuals import relative_error as ref

    for z, zs in ((-305.7, -305.69), (0.0, 1e-3), (2.0, 2.0)):
        assert tr.relative_error(z, zs) == ref(z, zs)
