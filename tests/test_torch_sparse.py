"""Sparse batch serving of the port against the reference (f64 on the
CPU, the reference's per-lane draws injected): the COO->ELL host helpers
and the sparse stacking, B4's and B5's plain versions against the
reference's Pallas kernels in interpret mode, the COO and ELL bucket
pipelines on every step rule x restart, and the ports of the reference's
sparse serving checks (ELL equal to COO, ELL megakernel equal to
stepped, both widths in the signature, zero-nnz instances)."""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import (  # noqa: F401  (one_torch_thread: a fixture)
    RULES,
    one_torch_thread,
    port_options,
    reference,
    reference_batch_draws,
)
from test_torch_batch import (
    PIPE_OPTS,
    _run_port_pipeline,
    _run_ref_pipeline,
    assert_pipeline_outputs_match,
)

from repro_torch.core.pdhg import PDHGOptions
from repro_torch.interop import from_reference_lp
from repro_torch.kernels import pdhg_megakernel as tmk
from repro_torch.kernels import sparse_mvm as tsm
from repro_torch.lp import SparseCOO, StandardLP, sparse_lp_stream, \
    sparse_random_standard_lp
from repro_torch.runtime import BatchSolver
from repro_torch.runtime import batch as tb

OPTS = PDHGOptions(max_iters=20000, tol=1e-5, check_every=64)


@pytest.fixture(scope="module")
def x64_module():
    jax = pytest.importorskip("jax")
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _ref():
    reference()
    from repro.kernels import sparse_mvm as rsm
    from repro.runtime import batch as rb

    return rsm, rb


def _zero_k_lp(m=6, n=10, package=None):
    """Feasible degenerate LP with an all-zero K (nnz=0): K@x = 0 = b,
    optimum is the lower bound wherever c > 0.  ``package`` is the port's
    ``lp`` module by default, or the reference's."""
    coo, lp_cls = ((SparseCOO, StandardLP) if package is None
                   else (package.SparseCOO, package.StandardLP))
    sp = coo(np.zeros(0), np.zeros(0, np.int64), np.zeros(0, np.int64),
             (m, n))
    c = np.linspace(0.5, 1.5, n)
    return lp_cls(c=c, K=sp, b=np.zeros(m), lb=np.zeros(n), ub=np.ones(n),
                  name="zeroK", x_opt=np.zeros(n), obj_opt=0.0)


def _ref_lp():
    reference()
    import repro.lp as rlp

    return rlp


# ---------------------------------------------------- host conversion ---

def test_ell_host_helpers_match_reference(rng):
    rsm, _ = _ref()
    assert tsm.ROW_BLOCK == rsm.ROW_BLOCK
    assert tsm.MIN_ELL_WIDTH == rsm.MIN_ELL_WIDTH
    for w in (0, 1, 3, 4, 5, 100):
        assert tsm.ell_width_bucket(w) == rsm.ell_width_bucket(w)
    K = rng.normal(size=(9, 13)) * (rng.random((9, 13)) < 0.3)
    sp = SparseCOO.from_dense(K)
    # an explicit zero and a duplicate-free COO with an empty row
    data = np.concatenate([sp.data, [0.0]])
    row = np.concatenate([sp.row, [0]])
    col = np.concatenate([sp.col, [1]])
    assert tsm.coo_row_widths(row, col, data, (9, 13)) == \
        rsm.coo_row_widths(row, col, data, (9, 13))
    for width in (None, 12):
        a = tsm.ell_from_coo(data, row, col, (9, 13), width=width)
        b = rsm.ell_from_coo(data, row, col, (9, 13), width=width)
        for p, r in zip(a, b):
            np.testing.assert_array_equal(p, r)
            assert p.dtype == r.dtype
    d, c = tsm.ell_from_coo(np.zeros(0), np.zeros(0, np.int64),
                            np.zeros(0, np.int64), (6, 10))
    assert d.shape == c.shape == (6, 0)


def test_sparse_stacking_matches_reference():
    _, rb = _ref()
    rlp = _ref_lp()
    lps = sparse_lp_stream(3, [(12, 24), (9, 20)], density=0.2, seed=1)
    lps.append(_zero_k_lp())
    ref_lps = rlp.sparse_lp_stream(3, [(12, 24), (9, 20)], density=0.2,
                                   seed=1)
    ref_lps.append(_zero_k_lp(package=rlp))
    for a, b in zip(tb.stack_problems_sparse(lps),
                    rb.stack_problems_sparse(ref_lps)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    for kw in ({}, {"m": 16, "n": 32, "wf": 16, "wa": 16}):
        for a, b in zip(tb.stack_problems_ell(lps, **kw),
                        rb.stack_problems_ell(ref_lps, **kw)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    assert tb.stack_problems_ell(lps)[0].shape[0] == 4


# ------------------------------------------------- B4, B5 plain versions ---

@pytest.mark.parametrize("lead,m,n,W", [((), 150, 40, 5), ((3,), 130, 57, 9),
                                        ((2,), 7, 11, 0)],
                         ids=["ragged", "batch3", "width0"])
def test_ell_matvec_plain_matches_reference(x64_module, rng, lead, m, n, W):
    import jax.numpy as jnp

    rsm, _ = _ref()
    data = rng.normal(size=(*lead, m, W))
    cols = rng.integers(0, n, size=(*lead, m, W)).astype(np.int32)
    v = rng.normal(size=(*lead, n))
    port = tsm.ell_matvec(torch.as_tensor(data), torch.as_tensor(cols),
                          torch.as_tensor(v))
    assert port.shape == (*lead, m)
    for k in np.ndindex(*lead):
        for use_pallas in (False, True):
            ref = rsm.ell_matvec(jnp.asarray(data[k]), jnp.asarray(cols[k]),
                                 jnp.asarray(v[k]), use_pallas=use_pallas)
            np.testing.assert_allclose(port[k].numpy(), np.asarray(ref),
                                       rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("data_shape,v_shape",
                         [((1, 5, 3), (2, 8)), ((2, 5, 3), (8,)),
                          ((5, 3), (2, 8))],
                         ids=["one-lane-operator", "batch-needs-lanes",
                              "lanes-on-one-operator"])
def test_ell_matvec_rejects_mismatched_lanes(data_shape, v_shape):
    data = torch.ones(data_shape, dtype=torch.float64)
    cols = torch.zeros(data_shape, dtype=torch.int32)
    with pytest.raises(ValueError, match="v must be"):
        tsm.ell_matvec(data, cols, torch.ones(v_shape, dtype=torch.float64))


@pytest.mark.parametrize("field,value", [("col", 10), ("col", -1),
                                         ("row", 6)])
def test_ell_stacking_rejects_out_of_range_indices(field, value):
    K = SparseCOO([1.0, 2.0], [0, 5], [3, 9], (6, 10))
    getattr(K, field)[1] = value
    lp = StandardLP(K=K, b=np.zeros(6), c=np.ones(10), lb=np.zeros(10),
                    ub=np.full(10, np.inf))
    with pytest.raises(ValueError, match="outside"):
        tb.stack_problems_ell([lp], wf=4, wa=4)


def _ell_window(seed, m=23, n=41, W=6):
    """One ELL window: K sparse, both forms from the same COO, unit-ish
    diagonals and steps that keep 16 steps bounded."""
    rng = np.random.default_rng(seed)
    K = rng.normal(size=(m, n)) * (rng.random((m, n)) < W / n) / np.sqrt(W)
    r, c = K.nonzero()
    df, cf = tsm.ell_from_coo(K[r, c], r, c, (m, n), width=3 * W)
    da, ca = tsm.ell_from_coo(K[r, c], c, r, (n, m), width=3 * W)
    kind = rng.integers(0, 3, n)
    lb = np.where(kind == 0, -0.5, np.where(kind == 1, 0.0, -np.inf))
    ub = np.where(kind == 0, 0.5, np.inf)
    x = np.clip(rng.uniform(-1, 1, n), lb, ub)
    return dict(data_f=df, cols_f=cf, data_a=da, cols_a=ca,
                b=rng.uniform(-1, 1, m), c=rng.uniform(-1, 1, n), lb=lb,
                ub=ub, T=rng.uniform(0.5, 1, n), Sigma=rng.uniform(0.5, 1, m),
                x=x, x_prev=x.copy(), x_bar=x.copy(),
                y=rng.uniform(-1, 1, m), tau=np.float64(0.3),
                sigma=np.float64(0.3))


@pytest.mark.parametrize("rule", list(RULES))
def test_fused_ell_steps_plain_matches_reference(x64_module, rule):
    reference()
    from repro.kernels import pdhg_megakernel as rmk

    w = _ell_window(3)
    gamma = RULES[rule]
    ref = rmk.fused_ell_steps(**w, n_steps=16, gamma=gamma, interpret=True)
    port = tmk.fused_ell_steps(**{k: torch.as_tensor(v)
                                  for k, v in w.items()},
                               n_steps=16, gamma=gamma)
    assert len(port) == len(ref) == 8
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12)


def test_fused_ell_steps_plain_batched_equals_each_lane():
    ws = [_ell_window(s) for s in (5, 6, 7)]
    stack = {k: torch.as_tensor(np.stack([w[k] for w in ws]))
             for k in ws[0]}
    stack["tau"] = torch.tensor([0.3, 0.2, 0.25], dtype=torch.float64)
    outs = tmk.fused_ell_steps(**stack, n_steps=12, gamma=0.05)
    for k, w in enumerate(ws):
        one = {key: torch.as_tensor(v) for key, v in w.items()}
        one["tau"] = stack["tau"][k]
        for b, s in zip(outs, tmk.fused_ell_steps(**one, n_steps=12,
                                                  gamma=0.05)):
            torch.testing.assert_close(b[k], s, rtol=1e-14, atol=1e-15)


# ------------------------------------------------------ the pipelines ---

def _sparse_lps():
    """The reference's instances (the port's are byte-identical)."""
    return _ref_lp().sparse_lp_stream(3, [(20, 40), (24, 48)],
                                      density=0.15, seed=2)


@pytest.mark.parametrize("restart", [True, False],
                         ids=["restart", "norestart"])
@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("kind", ["coo", "ell"])
def test_sparse_bucket_pipelines_match_reference(x64_module, kind, rule,
                                                 restart):
    _, rb = _ref()
    _, rpdhg = reference()
    lps = _sparse_lps()
    B = 4
    group = lps + [lps[0]] * (B - len(lps))
    ref_opts = rpdhg.PDHGOptions(step_rule=rule, gamma=RULES[rule],
                                 restart=restart, **PIPE_OPTS)
    if kind == "coo":
        arrays = rb.stack_problems_sparse(group, m=32, n=64, nnz=256)
        make_ref, make_port = (rb.make_sparse_bucket_pipeline,
                               tb.make_sparse_bucket_pipeline)
        ints = (1,)
    else:
        arrays = rb.stack_problems_ell(group, m=32, n=64, wf=16, wa=16)
        make_ref, make_port = (rb.make_ell_bucket_pipeline,
                               tb.make_ell_bucket_pipeline)
        ints = (1, 3)
    ref = _run_ref_pipeline(make_ref, ref_opts, arrays, B, 3)
    port, _ = _run_port_pipeline(make_port, port_options(ref_opts), arrays,
                                 32, 64, B, 3, int_fields=ints)
    assert_pipeline_outputs_match(port, ref, ref_opts.check_every)


def test_ell_scaling_diagonals_match_reference(x64_module):
    import jax.numpy as jnp

    _, rb = _ref()
    _, rpdhg = reference()
    lps = _sparse_lps()
    arrays = rb.stack_problems_ell(lps, m=32, n=64, wf=16, wa=16)
    ropts = rpdhg.PDHGOptions()
    t = [torch.as_tensor(a, dtype=torch.int32 if i in (1, 3)
                         else torch.float64) for i, a in enumerate(arrays)]
    port = tb._prep_one_ell(*t, PDHGOptions())
    for k in range(len(lps)):
        ref = rb._prep_one_ell(*(jnp.asarray(a[k]) for a in arrays), ropts)
        for p, r in zip(port[:10], ref):
            np.testing.assert_allclose(p[k].numpy(), np.asarray(r),
                                       rtol=1e-14, atol=0)


# ----------------------------------------------------- serving checks ---

@pytest.fixture(scope="module")
def ell_and_coo():
    lps = sparse_lp_stream(4, density=0.08, seed=3)
    opts = dataclasses.replace(OPTS, max_iters=1024)
    r_ell = BatchSolver(opts, torch_device="cpu").solve_stream(lps)
    r_coo = BatchSolver(dataclasses.replace(opts, sparse_kernel="bcoo"),
                        torch_device="cpu").solve_stream(lps)
    r_meg = BatchSolver(dataclasses.replace(opts, megakernel=True),
                        torch_device="cpu").solve_stream(lps)
    return r_ell, r_coo, r_meg


def test_ell_and_bcoo_stream_parity(ell_and_coo):
    r_ell, r_coo, _ = ell_and_coo
    for e, b in zip(r_ell, r_coo):
        assert e.iterations == b.iterations and e.status == b.status
        np.testing.assert_allclose(e.x, b.x, rtol=1e-7, atol=1e-9)
        np.testing.assert_allclose(e.y, b.y, rtol=1e-7, atol=1e-9)
        assert e.sparse and b.sparse


def test_ell_megakernel_stream_parity(ell_and_coo):
    r_ell, _, r_meg = ell_and_coo
    for e, m in zip(r_ell, r_meg):
        assert m.iterations == e.iterations
        np.testing.assert_allclose(m.x, e.x, rtol=1e-8, atol=1e-10)


def test_ell_bucket_signature_carries_both_widths():
    lo = sparse_random_standard_lp(24, 40, density=0.04, seed=0)
    hi = sparse_random_standard_lp(24, 40, density=0.5, seed=1)
    solver = BatchSolver(OPTS, torch_device="cpu")
    sig_lo = solver._sparse_signature(lo)
    sig_hi = solver._sparse_signature(hi)
    assert sig_lo[0] == "ell" and sig_hi[0] == "ell"
    assert sig_lo != sig_hi
    bcoo = BatchSolver(dataclasses.replace(OPTS, sparse_kernel="bcoo"),
                       torch_device="cpu")
    assert isinstance(bcoo._sparse_signature(lo), int)
    # and they match the reference's
    _, rb = _ref()
    _, rpdhg = reference()
    ref = rb.BatchSolver(rpdhg.PDHGOptions())
    from repro.lp import sparse_random_standard_lp as ref_sparse

    assert ref._sparse_signature(ref_sparse(24, 40, density=0.04,
                                            seed=0)) == sig_lo


def test_sparse_stream_never_densifies_and_matches_reference(x64_module):
    _, rb = _ref()
    _, rpdhg = reference()
    ref_lps = _sparse_lps()
    ref_opts = rpdhg.PDHGOptions(max_iters=512, tol=1e-5, check_every=64,
                                 lanczos_iters=16)
    ref = rb.BatchSolver(ref_opts).solve_stream(ref_lps)
    solver = BatchSolver(port_options(ref_opts), torch_device="cpu")
    port = solver.solve_stream([from_reference_lp(lp) for lp in ref_lps],
                               draws=reference_batch_draws(0))
    st = solver.last_stream_stats
    assert st["dense_stack_bytes"] == 0 and st["sparse_stack_bytes"] > 0
    for p, r in zip(port, ref):
        assert p.iterations == r.iterations and p.status == r.status
        assert p.mvm_calls == r.mvm_calls and p.sparse
        np.testing.assert_allclose(p.x, r.x, rtol=0, atol=1e-10)
        np.testing.assert_allclose(p.y, r.y, rtol=0, atol=1e-10)


@pytest.mark.parametrize("kernel", ["ell", "bcoo"])
def test_degenerate_zero_nnz_instances_serve_cleanly(kernel):
    zk = _zero_k_lp()
    opts = dataclasses.replace(OPTS, max_iters=2000, sparse_kernel=kernel)
    r = BatchSolver(opts, torch_device="cpu").solve_stream([zk])[0]
    assert np.all(np.isfinite(r.x)) and np.all(np.isfinite(r.y))
    assert r.status in ("optimal", "iteration_limit")
    np.testing.assert_allclose(r.x, np.zeros(10), atol=1e-4)
    # mixed into a healthy stream, it serves in one pass
    healthy = sparse_lp_stream(3, [(6, 10)], density=0.3, seed=9)
    results = BatchSolver(opts, torch_device="cpu").solve_stream(
        [zk] + healthy)
    assert all(np.all(np.isfinite(r.x)) for r in results)
