"""ELL row lengths and live lanes: the row-length helper, B4's plain
version with and without row lengths against the reference's
``ell_matvec_ref`` (f64 to 1e-13), B5's plain version with a partial
``active`` mask against the reference's megakernel in interpret mode
(1e-12), the ELL bucket pipeline with the megakernel against the
reference's with its draws injected, and a masked fused stream equal to
an unmasked one.  On a card (``cuda`` marker, skipped without one): B4
with row lengths against its plain version (ragged W = 13, a batch of 3,
a strided v, width 0, the NaN contract) and B5 with a partial mask.
"""
import numpy as np
import pytest
import torch
from _torch_parity import RULES, port_options, reference
from test_torch_batch import (
    PIPE_OPTS,
    _run_port_pipeline,
    _run_ref_pipeline,
    assert_pipeline_outputs_match,
)
from test_torch_sparse import _ell_window, _sparse_lps

from repro_torch import kernels
from repro_torch.core import engine
from repro_torch.core.pdhg import PDHGOptions
from repro_torch.kernels import pdhg_megakernel as tmk
from repro_torch.kernels import sparse_mvm as tsm
from repro_torch.lp import sparse_lp_stream
from repro_torch.runtime import BatchSolver
from repro_torch.runtime import batch as tb


@pytest.fixture(scope="module")
def x64_module():
    jax = pytest.importorskip("jax")
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _forms(rng, lead, m, n, W, density=0.1):
    """ELL forms from ``ell_from_coo`` at width W (some rows empty, all
    padding (0, 0)), then an interior zero in the first row that has
    three or more entries: a stored slot whose value is 0."""
    data = np.zeros((*lead, m, W))
    cols = np.zeros((*lead, m, W), np.int32)
    for k in np.ndindex(*lead):
        mask = rng.random((m, n)) < density
        mask &= np.cumsum(mask, axis=1) <= W    # at most W a row
        K = rng.normal(size=(m, n)) * mask
        K[: m // 4] = 0.0                   # a block of empty rows
        r, c = K.nonzero()
        d, cl = tsm.ell_from_coo(K[r, c], r, c, (m, n), width=W)
        full = np.flatnonzero((d != 0).sum(-1) >= 3)
        if full.size:
            d[full[0], 1] = 0.0
        data[k], cols[k] = d, cl
    return data, cols


def _lengths(data, cols):
    """The row lengths by hand: 1 + the last slot that is not (0, 0)."""
    stored = (data != 0) | (cols != 0)
    lengths = np.zeros(data.shape[:-1], np.int32)
    for idx in np.ndindex(*lengths.shape):
        slots = np.flatnonzero(stored[idx])
        lengths[idx] = slots[-1] + 1 if slots.size else 0
    return lengths


# ------------------------------------------------------ the helper ---

@pytest.mark.parametrize("lead,m,n,W", [((), 40, 30, 12), ((3,), 25, 19, 8),
                                        ((2,), 7, 11, 0)],
                         ids=["one", "batch3", "width0"])
def test_ell_row_len_of_forms_from_coo(rng, lead, m, n, W):
    data, cols = _forms(rng, lead, m, n, W)
    rl = tsm.ell_row_len(torch.as_tensor(data), torch.as_tensor(cols))
    assert rl.dtype == torch.int32 and tuple(rl.shape) == (*lead, m)
    np.testing.assert_array_equal(rl.numpy(), _lengths(data, cols))
    if W:
        # empty rows are 0 long; an interior zero does not end its row
        assert (rl.numpy()[..., : m // 4] == 0).all()
        counts = (data != 0).sum(-1)
        assert (rl.numpy() >= counts).all()
        assert (rl.numpy() > counts).any()


def test_ell_row_len_counts_a_trailing_zero_with_a_column():
    """A slot with value 0 at a column other than 0 is not padding: its
    product 0 * v[col] is NaN when v[col] is, so the row keeps it."""
    data = torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    cols = torch.tensor([[3, 2, 0, 0], [0, 0, 0, 0]], dtype=torch.int32)
    assert tsm.ell_row_len(data, cols).tolist() == [2, 0]


# ------------------------------------------------------------ B4 ---

@pytest.mark.parametrize("lead,m,n,W", [((), 150, 40, 9), ((3,), 130, 57, 12),
                                        ((2,), 7, 11, 0)],
                         ids=["ragged", "batch3", "width0"])
@pytest.mark.parametrize("with_len", [False, True],
                         ids=["all-slots", "row-len"])
def test_ell_matvec_plain_with_row_len_matches_reference(
        x64_module, rng, lead, m, n, W, with_len):
    import jax.numpy as jnp

    reference()
    from repro.kernels import sparse_mvm as rsm

    data, cols = _forms(rng, lead, m, n, W)
    v = rng.normal(size=(*lead, n))
    t = [torch.as_tensor(a) for a in (data, cols, v)]
    rl = tsm.ell_row_len(t[0], t[1]) if with_len else None
    port = tsm.ell_matvec(*t, row_len=rl)
    assert port.shape == (*lead, m)
    for k in np.ndindex(*lead):
        ref = rsm.ell_matvec_ref(jnp.asarray(data[k]), jnp.asarray(cols[k]),
                                 jnp.asarray(v[k]))
        np.testing.assert_allclose(port[k].numpy(), np.asarray(ref),
                                   rtol=1e-13, atol=1e-13)


def test_ell_matvec_plain_row_len_keeps_the_nan_contract(x64_module, rng):
    """v[0] = inf: every padded row is NaN in the reference (0 * inf in
    its padding) and with row lengths alike; full rows stay finite."""
    import jax.numpy as jnp

    reference()
    from repro.kernels import sparse_mvm as rsm

    data, cols = _forms(rng, (), 60, 30, 10, density=0.2)
    v = rng.normal(size=30)
    v[0] = np.inf
    t = [torch.as_tensor(a) for a in (data, cols, v)]
    port = tsm.ell_matvec(*t, row_len=tsm.ell_row_len(t[0], t[1]))
    ref = np.asarray(rsm.ell_matvec_ref(*(jnp.asarray(a)
                                          for a in (data, cols, v))))
    np.testing.assert_array_equal(np.isnan(port.numpy()), np.isnan(ref))
    assert np.isnan(ref).any() and not np.isnan(ref).all()
    ok = ~np.isnan(ref)
    np.testing.assert_allclose(port.numpy()[ok], ref[ok], rtol=1e-13,
                               atol=1e-13)


@pytest.mark.parametrize("shape,dtype", [((2, 4), torch.int32),
                                         ((2, 5), torch.int64)],
                         ids=["shape", "dtype"])
def test_ell_matvec_rejects_bad_row_lengths(shape, dtype):
    data = torch.ones(2, 5, 3, dtype=torch.float64)
    cols = torch.zeros(2, 5, 3, dtype=torch.int32)
    v = torch.ones(2, 8, dtype=torch.float64)
    with pytest.raises(ValueError, match="row lengths"):
        tsm.ell_matvec(data, cols, v, torch.ones(shape, dtype=dtype))


# ------------------------------------------------------------ B5 ---

def _stacked_windows(seeds, W=6):
    """Windows of ``test_torch_sparse`` stacked, forms of width 3 W."""
    ws = [_ell_window(s, W=W) for s in seeds]
    stack = {k: torch.as_tensor(np.stack([w[k] for w in ws]))
             for k in ws[0]}
    stack["tau"] = torch.tensor([0.3, 0.2, 0.25][:len(seeds)],
                                dtype=torch.float64)
    return ws, stack


@pytest.mark.parametrize("rule", list(RULES))
def test_fused_ell_steps_plain_masked_lanes(x64_module, rule):
    """Lanes off the mask come back as they went in (zero sums); live
    lanes equal the reference's megakernel run on that lane alone."""
    reference()
    from repro.kernels import pdhg_megakernel as rmk

    gamma = RULES[rule]
    ws, stack = _stacked_windows((5, 6, 7))
    active = torch.tensor([True, False, True])
    rl = dict(row_len_f=tsm.ell_row_len(stack["data_f"], stack["cols_f"]),
              row_len_a=tsm.ell_row_len(stack["data_a"], stack["cols_a"]))
    outs = tmk.fused_ell_steps(**stack, n_steps=16, gamma=gamma,
                               active=active, **rl)
    ins = ("x", "x_prev", "x_bar", "y", "tau", "sigma")
    for o, k in zip(outs[:6], ins):
        assert torch.equal(o[1], stack[k][1]), k
    assert not outs[6][1].any() and not outs[7][1].any()
    for lane in (0, 2):
        w = dict(ws[lane], tau=np.float64(stack["tau"][lane]))
        ref = rmk.fused_ell_steps(**w, n_steps=16, gamma=gamma,
                                  interpret=True)
        for p, r in zip(outs, ref):
            np.testing.assert_allclose(p[lane].numpy(), np.asarray(r),
                                       rtol=1e-12, atol=1e-12)


def test_ell_megakernel_pipeline_matches_reference(x64_module):
    """The ELL bucket pipeline with the megakernel (B5's plain version,
    the loop's active mask passed in) against the reference's, its
    per-lane draws injected; a filler lane included."""
    _, rpdhg = reference()
    from repro.runtime import batch as rb

    lps = _sparse_lps()
    B = 4
    group = lps + [lps[0]] * (B - len(lps))
    ref_opts = rpdhg.PDHGOptions(megakernel=True,
                                 **dict(PIPE_OPTS, max_iters=4096))
    arrays = rb.stack_problems_ell(group, m=32, n=64, wf=16, wa=16)
    ref = _run_ref_pipeline(rb.make_ell_bucket_pipeline, ref_opts, arrays,
                            B, 3)
    port, _ = _run_port_pipeline(tb.make_ell_bucket_pipeline,
                                 port_options(ref_opts), arrays, 32, 64, B,
                                 3, int_fields=(1, 3))
    assert_pipeline_outputs_match(port, ref, ref_opts.check_every)
    assert len(set(ref[2].tolist())) > 1      # lanes stop apart


def test_masked_fused_stream_equals_unmasked(monkeypatch):
    """Skipping stopped lanes changes no result: a megakernel stream
    whose B5 is handed the loop's mask equals one that steps every lane,
    in iterations, MVM charge, x and y, bit for bit."""
    lps = sparse_lp_stream(4, [(24, 48)], density=0.15, seed=2)
    opts = PDHGOptions(max_iters=4096, tol=1e-5, check_every=64,
                       megakernel=True)
    masks = []
    real = engine.make_fused_ell

    def recording(*args, **kw):
        fuse = real(*args, **kw)

        def hook(state, n_steps, active=None):
            masks.append(active.clone())
            return fuse(state, n_steps, active)
        return hook

    monkeypatch.setattr(engine, "make_fused_ell", recording)
    masked = BatchSolver(opts, torch_device="cpu").solve_stream(lps)
    assert any(not bool(m.all()) for m in masks)

    def unmasked(*args, **kw):
        fuse = real(*args, **kw)
        return lambda state, n_steps, active=None: fuse(state, n_steps)

    monkeypatch.setattr(engine, "make_fused_ell", unmasked)
    full = BatchSolver(opts, torch_device="cpu").solve_stream(lps)
    assert len({r.iterations for r in masked}) > 1      # lanes stop apart
    for a, b in zip(masked, full):
        assert (a.iterations, a.mvm_calls) == (b.iterations, b.mvm_calls)
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)




# ------------------------------------------------------- on a card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(outs, refs):
    """Largest error of an output over that output's own largest |value|."""
    return max(float((o - r).abs().max()) / max(float(r.abs().max()), 1e-300)
               for o, r in zip(outs, refs))


# B4: one row sum of up to 64 slots, in another order than torch's (the
# limit chip_smoke.py holds it to); B5: 50 steps of them
B4_TOLS = [(torch.float64, 1e-13), (torch.float32, 1e-5)]
B5_TOLS = [(torch.float64, 1e-12), (torch.float32, 1e-5)]


def _card_forms(dev, dtype, lead, m, n, W, seed=0):
    rng = np.random.default_rng(seed)
    data, cols = _forms(rng, lead, m, n, W)
    d = torch.as_tensor(data, device=dev, dtype=dtype)
    c = torch.as_tensor(cols, device=dev)
    return d, c, tsm.ell_row_len(d, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", B4_TOLS, ids=["f64", "f32"])
@pytest.mark.parametrize("lead,m,n,W", [((), 777, 1235, 13),
                                        ((3,), 300, 517, 7),
                                        ((3,), 2048, 4096, 64)],
                         ids=["ragged", "batch3", "batch3-wide"])
def test_ell_matvec_kernel_with_row_len_matches_plain_on_card(
        cuda, dtype, tol, lead, m, n, W):
    d, c, rl = _card_forms(cuda, dtype, lead, m, n, W)
    v = torch.randn((*lead, n), dtype=dtype, device=cuda)
    kernels.reset_launch_counts()
    out = tsm.ell_matvec(d, c, v, rl)
    every = tsm.ell_matvec(d, c, v)
    ref = tsm.ell_matvec_plain(d, c, v, rl)
    torch.cuda.synchronize()
    assert _rel([out, every], [ref, ref]) <= tol
    assert kernels.launch_counts()["ell_matvec"] == 2


@pytest.mark.cuda
def test_ell_matvec_kernel_with_row_len_reads_a_strided_slice(cuda):
    d, c, rl = _card_forms(cuda, torch.float64, (3,), 50, 40, 8, seed=2)
    full = torch.randn(3, 90, dtype=torch.float64, device=cuda)
    out = tsm.ell_matvec(d, c, full[:, 50:], rl)
    ref = tsm.ell_matvec_plain(d, c, full[:, 50:].contiguous(), rl)
    torch.cuda.synchronize()
    assert _rel([out], [ref]) <= 1e-13


@pytest.mark.cuda
def test_ell_matvec_kernel_with_row_len_width_zero(cuda):
    d, c, rl = _card_forms(cuda, torch.float64, (2,), 6, 10, 0)
    kernels.reset_launch_counts()
    out = tsm.ell_matvec(d, c, torch.ones(2, 10, dtype=torch.float64,
                                          device=cuda), rl)
    assert torch.equal(out, torch.zeros(2, 6, dtype=torch.float64,
                                        device=cuda))
    assert kernels.launch_counts()["ell_matvec"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("W", [12, 13], ids=["vector", "scalar"])
def test_ell_matvec_kernel_keeps_the_nan_contract(cuda, W):
    """v[0] = inf: the rows the plain version turns to NaN (padded ones),
    and only those, are NaN from the kernel with row lengths."""
    d, c, rl = _card_forms(cuda, torch.float64, (), 300, 200, W, seed=4)
    v = torch.randn(200, dtype=torch.float64, device=cuda)
    v[0] = float("inf")
    out = tsm.ell_matvec(d, c, v, rl)
    ref = tsm.ell_matvec_plain(d, c, v, rl)
    torch.cuda.synchronize()
    nan, fin = torch.isnan(ref), torch.isfinite(ref)
    assert torch.equal(torch.isnan(out), nan) and nan.any()
    # a full row with an entry in column 0 is +-inf on both sides
    assert torch.equal(out[~fin & ~nan], ref[~fin & ~nan])
    assert _rel([out[fin]], [ref[fin]]) <= 1e-13


def _card_window(dev, dtype, seeds, W=6):
    _, stack = _stacked_windows(seeds, W)
    w = {k: v.to(dev, dtype if v.is_floating_point() else v.dtype)
         for k, v in stack.items()}
    w["row_len_f"] = tsm.ell_row_len(w["data_f"], w["cols_f"])
    w["row_len_a"] = tsm.ell_row_len(w["data_a"], w["cols_a"])
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", B5_TOLS, ids=["f64", "f32"])
@pytest.mark.parametrize("gamma", [0.0, 0.05])
@pytest.mark.parametrize("W", [4, 5], ids=["vector", "scalar"])
def test_fused_ell_kernel_with_a_partial_mask_on_card(cuda, dtype, tol,
                                                      gamma, W):
    w = _card_window(cuda, dtype, (5, 6, 7), W)
    active = torch.tensor([True, False, True], device=cuda)
    before = {k: v.clone() for k, v in w.items()}
    kernels.reset_launch_counts()
    outs = tmk.fused_ell_steps(**w, n_steps=50, gamma=gamma, active=active)
    refs = tmk.fused_ell_steps_plain(**w, n_steps=50, gamma=gamma,
                                     active=active)
    torch.cuda.synchronize()
    assert _rel(outs, refs) <= tol
    ins = ("x", "x_prev", "x_bar", "y", "tau", "sigma")
    for o, k in zip(outs[:6], ins):
        assert torch.equal(o[1], w[k][1]), k
    assert not outs[6][1].any() and not outs[7][1].any()
    assert all(torch.equal(w[k], before[k]) for k in w)
    assert kernels.launch_counts()["fused_ell_steps"] == 1


@pytest.mark.cuda
def test_stepped_and_fused_ell_windows_with_row_len_agree_on_card(cuda):
    """B4 + B1 + B4 + B2 a step, both B4 with row lengths, and one B5
    launch with them sum every row in the same order."""
    w = _card_window(cuda, torch.float64, (8, 9, 10))
    op = engine.sparse_ell_operator(w["data_f"], w["cols_f"], w["data_a"],
                                    w["cols_a"])
    s = engine.PDHGState(w["x"], w["x_prev"], w["x_bar"], w["y"], w["tau"],
                         w["sigma"])
    vecs = (w["b"], w["c"], w["lb"], w["ub"], w["T"], w["Sigma"])
    for _ in range(40):
        s = engine.pdhg_step(op, engine.CUDA_UPDATES, *vecs, 0.0, s)
    fused = tmk.fused_ell_steps(**w, n_steps=40, gamma=0.0)
    torch.cuda.synchronize()
    for a, b in zip((s.x, s.x_prev, s.x_bar, s.y), fused[:4]):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
