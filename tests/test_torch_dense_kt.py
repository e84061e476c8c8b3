"""B3's two forms: the two-matrix form (a distinct ``K_adj``) and the
transpose form (``K_adj=None``, the adjoint being K^T, which reads K once
a step), each with the loop's ``active`` mask.

On the CPU: the plain version with half the lanes masked off against
the reference's megakernel in interpret mode on each live lane alone
(1e-12; the stopped lanes come back unchanged with zero sums), and a
dense megakernel stream whose B3 is handed the loop's mask equal, bit
for bit, to one that steps every lane.  On a card (``cuda`` marker,
skipped without one): each form against the plain version on the same
inputs, f64 to 1e-12 and f32 to 1e-5, at a ragged shape, a batch of 3,
tiny lanes, more lanes than blocks, a row too long for the transpose
form's shared-memory ring, and with half the lanes masked off; the
caller's tensors unchanged and one launch each.
"""
import numpy as np
import pytest
import torch
from _torch_parity import RULES, reference
from test_torch_kernels import _window

from repro_torch import kernels
from repro_torch.core import engine
from repro_torch.core.pdhg import PDHGOptions
from repro_torch.kernels import pdhg_megakernel as tmk
from repro_torch.lp import random_standard_lp
from repro_torch.runtime import BatchSolver

STATE = ("x", "x_prev", "x_bar", "y", "tau", "sigma")


def _stack(ws, transpose):
    """Windows of ``test_torch_kernels`` stacked, per-lane step sizes;
    ``K_adj`` None for the transpose form."""
    out = {k: torch.as_tensor(np.stack([w[k] for w in ws])) for k in ws[0]}
    out["tau"] = torch.tensor([0.3, 0.2, 0.25][:len(ws)],
                              dtype=torch.float64)
    if transpose:
        out["K_adj"] = None
    return out


@pytest.mark.parametrize("transpose", [False, True], ids=["two", "kt"])
@pytest.mark.parametrize("rule", list(RULES))
def test_fused_dense_steps_plain_masked_lanes(x64, rule, transpose):
    """Lanes off the mask come back as they went in (zero sums); live
    lanes equal the reference's megakernel run on that lane alone."""
    reference()
    from repro.kernels import pdhg_megakernel as rmk

    gamma = RULES[rule]
    ws = [_window(s, 7, 11) for s in (5, 6, 7)]
    stack = _stack(ws, transpose)
    active = torch.tensor([True, False, True])
    outs = tmk.fused_dense_steps(**stack, n_steps=16, gamma=gamma,
                                 active=active)
    for o, k in zip(outs[:6], STATE):
        assert torch.equal(o[1], stack[k][1]), k
    assert not outs[6][1].any() and not outs[7][1].any()
    for lane in (0, 2):
        w = dict(ws[lane], tau=np.float64(stack["tau"][lane]))
        ref = rmk.fused_dense_steps(**w, n_steps=16, gamma=gamma,
                                    interpret=True)
        for p, r in zip(outs, ref):
            np.testing.assert_allclose(p[lane].numpy(), np.asarray(r),
                                       rtol=1e-12, atol=1e-12)


def test_masked_dense_megakernel_stream_equals_unmasked(monkeypatch):
    """Skipping stopped lanes changes no result: a dense megakernel
    stream whose B3 (the transpose form, as the bucket pipeline mounts
    it) is handed the loop's mask equals one that steps every lane, in
    iterations, MVM charge, x and y, bit for bit."""
    lps = [random_standard_lp(12, 20, seed=s) for s in range(4)]
    opts = PDHGOptions(max_iters=4096, tol=1e-6, check_every=64,
                       megakernel=True)
    masks, adjoints = [], []
    real = engine.make_fused_dense

    def recording(*args, **kw):
        adjoints.append(args[1])
        fuse = real(*args, **kw)

        def hook(state, n_steps, active=None):
            masks.append(active.clone())
            return fuse(state, n_steps, active)
        return hook

    monkeypatch.setattr(engine, "make_fused_dense", recording)
    masked = BatchSolver(opts, torch_device="cpu").solve_stream(lps)
    assert adjoints and all(a is None for a in adjoints)
    assert any(not bool(m.all()) for m in masks)

    def unmasked(*args, **kw):
        fuse = real(*args, **kw)
        return lambda state, n_steps, active=None: fuse(state, n_steps)

    monkeypatch.setattr(engine, "make_fused_dense", unmasked)
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


def _card_window(dev, dtype, lead, m, n, seed=0):
    """A well-posed window on the card: K ~ N(0, 1/n), a mix of finite,
    half-infinite and free bounds, per-lane steps."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def vec(*shape, lo=-1.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(*shape, generator=g, dtype=dtype,
                                           device=dev)

    K = torch.randn(*lead, m, n, generator=g, dtype=dtype,
                    device=dev) / n ** 0.5
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    lb = torch.where(torch.rand(*lead, n, generator=g, device=dev) < 0.5,
                     vec(*lead, n, hi=-0.1), -inf)
    ub = vec(*lead, n, lo=0.1)
    x = torch.clamp(vec(*lead, n), lb, ub)
    tau = 0.3 * torch.ones(lead, dtype=dtype, device=dev)
    return dict(K=K, b=vec(*lead, m), c=vec(*lead, n), lb=lb, ub=ub,
                T=vec(*lead, n, lo=0.5), Sigma=vec(*lead, m, lo=0.5), x=x,
                x_prev=x.clone(), x_bar=x.clone(), y=vec(*lead, m), tau=tau,
                sigma=tau.clone())


# 100 steps of row sums in another order than torch's (the limits
# chip_smoke.py holds B3 to)
B3_TOLS = [(torch.float64, 1e-12), (torch.float32, 1e-5)]
# (lead, m, n, half the lanes masked): an odd n (no 16-byte rows), a
# batch, lanes of the small CLI stream, more lanes than the card has SMs,
# and rows longer than the transpose form's ring holds (8192 in f64,
# 16384 in f32)
B3_CASES = {"ragged": ((), 777, 1235, False),
            "batch3": ((3,), 133, 217, False),
            "batch3-half": ((3,), 133, 217, True),
            "tiny": ((5,), 8, 14, False),
            "tiny-half": ((5,), 8, 14, True),
            "many": ((200,), 10, 18, False),
            "many-half": ((200,), 10, 18, True),
            "wide": ((), 64, 20000, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", B3_TOLS, ids=["f64", "f32"])
@pytest.mark.parametrize("lead,m,n,masked", list(B3_CASES.values()),
                         ids=list(B3_CASES))
def test_dense_forms_match_plain_on_card(cuda, dtype, tol, lead, m, n,
                                         masked):
    w = _card_window(cuda, dtype, lead, m, n)
    active = (torch.arange(lead[0], device=cuda) % 2 == 0 if masked
              else None)
    K_adj = w["K"].mT.contiguous()
    before = {k: v.clone() for k, v in w.items()}
    for gamma in (0.0, 0.05):
        kernels.reset_launch_counts()
        kt = tmk.fused_dense_steps(w["K"], None, *list(w.values())[1:],
                                   n_steps=100, gamma=gamma, active=active)
        two = tmk.fused_dense_steps(w["K"], K_adj, *list(w.values())[1:],
                                    n_steps=100, gamma=gamma, active=active)
        ref = tmk.fused_dense_steps_plain(
            w["K"], None, *list(w.values())[1:], n_steps=100, gamma=gamma,
            active=active)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["fused_dense_steps_kt"] == 1
        assert counts["fused_dense_steps"] == 1
        assert _rel(kt, ref) <= tol
        assert _rel(two, ref) <= tol
        assert all(torch.equal(w[k], before[k]) for k in w)
        if masked:
            off = ~active
            for outs in (kt, two):
                for o, k in zip(outs[:6], STATE):
                    assert torch.equal(o[off], w[k][off]), k
                assert not outs[6][off].any() and not outs[7][off].any()


@pytest.mark.cuda
def test_transpose_form_is_bit_identical_run_to_run(cuda):
    """No atomics: two runs of the transpose form agree bit for bit."""
    w = _card_window(cuda, torch.float64, (), 1000, 2048, seed=3)
    a = tmk.fused_dense_steps_kt(**w, n_steps=50, gamma=0.05)
    b = tmk.fused_dense_steps_kt(**w, n_steps=50, gamma=0.05)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
