"""B3's two forms: the two-matrix form (a distinct ``K_adj``) and the
transpose form (``K_adj=None``, the adjoint being K^T, which reads K once
a step), each with the loop's ``active`` mask.

On the CPU: the plain version with half the lanes masked off against
the reference's megakernel in interpret mode on each live lane alone
(1e-12; the stopped lanes come back unchanged with zero sums), and a
dense megakernel stream whose B3 is handed the loop's mask equal, bit
for bit, to one that steps every lane.  The rule that makes the
transpose form a card's default dense window where K's shape favours it
(``engine.transpose_form_window``): each condition it reads, on both
sides of each limit, the solve core running its verdict, the stepped
route that the card compares against, and the megakernel option still
fusing every window.  On a card (``cuda`` marker,
skipped without one): each form against the plain version on the same
inputs, f64 to 1e-12 and f32 to 1e-5, at a ragged shape, a batch of 3,
tiny lanes, more lanes than blocks, a row too long for the transpose
form's shared-memory ring, and with half the lanes masked off; the
caller's tensors unchanged and one launch each; and a default solve of
``rand:2560x5120`` in f64 on the transpose form once a window, on the
iterations of the stepped solve and within 1e-8 of its x.
"""
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch
from _torch_parity import RULES, reference
from test_torch_kernels import _window

from repro_torch import kernels, spans
from repro_torch.core import engine
from repro_torch.core.pdhg import PDHGOptions, solve_jit
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


# ------------------------------------------------ the window's rule ---

def stepped_solve(*args, **kw):
    """``chip_smoke.stepped_solve``: a dense LP solved as ``solve_jit``
    solves it, every window stepped (``engine.pdhg_loop`` on
    ``engine.dense_operator``, no fuse hook), the route of the card's
    main comparison."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.stepped_solve(*args, **kw)


# each case changes these defaults (the dense cell's K: f64, rows of 60
# KiB, 236 MB) -> transpose form; every limit of the rule on both sides
RULE_DEFAULTS = dict(kind="dense", shape=(3840, 7680), size=8,
                     on_card=True, ptr=0, distinct=False, sigma_read=0.0,
                     kernel="cuda")
RULE_CASES = {
    "picked": ({}, True),
    "f64-16k-rows": ({"shape": (6400, 2048)}, True),
    "f64-8k-rows": ({"shape": (12800, 1024)}, False),
    "f64-tall-1k-rows": ({"shape": (102400, 128)}, False),
    "f64-64k-rows": ({"shape": (2048, 8192)}, True),
    "f64-wide": ({"shape": (2048, 16384)}, False),
    "f64-below-l2": ({"shape": (512, 4096)}, True),
    "f32-at-l2": ({"shape": (2560, 5120), "size": 4}, True),
    "f32-below-l2": ({"shape": (1024, 4096), "size": 4}, False),
    "f32-8k-rows": ({"shape": (12800, 2048), "size": 4}, False),
    "f32-64k-rows": ({"shape": (2048, 16384), "size": 4}, True),
    "f32-wide": ({"shape": (1024, 32768), "size": 4}, False),
    "f32-stack": ({"shape": (4, 1024, 4096), "size": 4}, True),
    "odd-row": ({"shape": (3840, 7681)}, False),
    "unaligned": ({"ptr": 8}, False),
    "distinct-adjoint": ({"distinct": True}, False),
    "noisy": ({"sigma_read": 0.05}, False),
    "plain-kernel": ({"kernel": "torch"}, False),
    "cpu": ({"on_card": False}, False),
    "sparse": ({"kind": "sparse"}, False),
    "fused": ({"kind": "fused"}, False),
}
L2_BYTES = 50 << 20


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_transpose_form_window_rule(monkeypatch, case):
    """The transpose form only for the default dense operator, noiseless,
    with K^T as its adjoint, on the CUDA update kernels, on a card, with
    16-byte aligned rows of 16-64 KiB and, in f32, K at least the card's
    L2 cache; every condition that fails keeps the stepped window."""
    over, want = RULE_CASES[case]
    c = {**RULE_DEFAULTS, **over}
    K = torch.randn(6, 10, dtype=torch.float64)
    K_adj = K.mT.contiguous() if c["distinct"] else None
    op = engine.dense_operator(K, K.mT if K_adj is None else K_adj,
                               c["sigma_read"], torch.Generator())
    if c["kind"] == "sparse":
        op = engine.sparse_operator(K.to_sparse())
    elif c["kind"] == "fused":
        op = op._replace(fuse=engine.make_fused_dense(
            K, None, *(torch.ones(d, dtype=K.dtype) for d in (6, 10, 10,
                                                              10, 10, 6)),
            0.0))
    # the rule reads where K lives, its shape, element size, address and
    # bytes, and that device's L2: a stand-in puts such a K on a card of
    # 50 MB
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            L2_cache_size=L2_BYTES))
    K_fwd = (types.SimpleNamespace(
        is_cuda=True, device="cuda", shape=c["shape"],
        nbytes=int(np.prod(c["shape"])) * c["size"],
        element_size=lambda: c["size"], data_ptr=lambda: c["ptr"])
        if c["on_card"] else K)
    assert engine.transpose_form_window(op, K_fwd, K_adj, c["sigma_read"],
                                        c["kernel"]) is want


def _counting_kt(monkeypatch):
    """Record the steps of each transpose-form window."""
    windows = []
    real = tmk.fused_dense_steps_kt

    def counted(*args, **kw):
        windows.append(kw["n_steps"])
        return real(*args, **kw)

    monkeypatch.setattr(tmk, "fused_dense_steps_kt", counted)
    return windows


def _solve(entry, lps, opts):
    if entry == "solve_jit":
        return [solve_jit(lp, opts, device="cpu") for lp in lps]
    return BatchSolver(opts, torch_device="cpu").solve_stream(lps)


@pytest.mark.parametrize("entry", ["solve_jit", "batch"])
def test_the_rule_picks_each_default_dense_window(monkeypatch, entry):
    """The solve core asks the rule once for the dense operator it builds
    and runs its verdict: on the CPU the stepped window; where it says
    yes, B3's transpose form once a window (here its plain version), the
    same solve as the megakernel option's, bit for bit."""
    lps = [random_standard_lp(12, 20, seed=s) for s in range(3)]
    opts = PDHGOptions(max_iters=2000, tol=1e-6, check_every=64)
    verdicts = []
    real = engine.transpose_form_window

    def rule(*args):
        verdicts.append(real(*args))
        return verdicts[-1]

    monkeypatch.setattr(engine, "transpose_form_window", rule)
    windows = _counting_kt(monkeypatch)
    stepped = _solve(entry, lps, opts)
    assert verdicts and not any(verdicts) and windows == []

    monkeypatch.setattr(engine, "transpose_form_window",
                        lambda *args: True)
    fused = _solve(entry, lps, opts)
    assert windows and set(windows) == {opts.check_every}
    windows.clear()
    mega = _solve(entry, lps, PDHGOptions(**{**vars(opts),
                                             "megakernel": True}))
    assert windows
    for f, m, s in zip(fused, mega, stepped):
        assert (f.iterations, f.mvm_calls) == (m.iterations, m.mvm_calls)
        np.testing.assert_array_equal(f.x, m.x)
        np.testing.assert_array_equal(f.y, m.y)
        assert (f.iterations, f.status) == (s.iterations, s.status)


def test_the_stepped_route_is_solve_jits_stepped_solve(monkeypatch):
    """The stepped route the card compares against starts where
    ``solve_jit`` starts and steps every window, whatever the rule says:
    on the CPU, where ``solve_jit`` steps too, the two solves agree bit
    for bit; with the rule made to say yes, the route still launches no
    transpose-form window."""
    lp = random_standard_lp(12, 20, seed=1)
    opts = PDHGOptions(max_iters=2000, check_every=64)
    ref = solve_jit(lp, opts, device="cpu")
    monkeypatch.setattr(engine, "transpose_form_window",
                        lambda *args: True)
    windows = _counting_kt(monkeypatch)
    res = stepped_solve(lp, opts, ref.sigma_max, device="cpu")
    assert windows == []
    assert (res.iterations, res.status) == (ref.iterations, ref.status)
    np.testing.assert_array_equal(res.x, ref.x)
    np.testing.assert_array_equal(res.y, ref.y)
    assert res.obj == ref.obj


@pytest.mark.parametrize("distinct", [False, True], ids=["kt", "two"])
@pytest.mark.parametrize("m,n", [(8, 14), (40, 70), (96, 160)])
def test_megakernel_fuses_every_window_whatever_the_rule(monkeypatch, m, n,
                                                         distinct):
    """``megakernel=True`` fuses every window at every size, where the
    rule keeps the stepped window too (off a card, below the L2 cache):
    the transpose form without a ``K_adj``, the two-matrix form with
    one."""
    monkeypatch.setattr(engine, "transpose_form_window",
                        lambda *args: False)
    mounted = []
    real = engine.make_fused_dense

    def recording(*args, **kw):
        mounted.append(args[1] is None)
        return real(*args, **kw)

    monkeypatch.setattr(engine, "make_fused_dense", recording)
    lp = random_standard_lp(m, n, seed=2)
    opts = PDHGOptions(max_iters=256, check_every=64, megakernel=True)
    K_adj = np.asarray(lp.K).T.copy() if distinct else None
    res = solve_jit(lp, opts, K_adj=K_adj, device="cpu")
    assert mounted == [not distinct]
    assert res.iterations == 256 or res.status == "optimal"


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


@pytest.mark.cuda
def test_default_dense_solve_runs_the_transpose_form_on_card(cuda):
    """``solve_jit`` with default options on ``rand:2560x5120`` in f64
    (K of 105 MB): B3's transpose form once a window and nothing else,
    no CUDA graph, every ``loop.window`` span ``fused``; the same
    iterations as the stepped solve (cuBLAS products and the step pair,
    ``stepped_solve``) and x within 1e-8 of its x."""
    lp = random_standard_lp(2560, 5120, seed=0)
    opts = PDHGOptions(max_iters=40000, tol=1e-6, check_every=100)
    kernels.reset_launch_counts()
    engine.GRAPHS.update(captures=0, replays=0)
    with spans.recording():
        fused = solve_jit(lp, opts, device=cuda)
    counts, graphs = kernels.launch_counts(), dict(engine.GRAPHS)
    modes = {r["attrs"]["mode"] for r in spans.records()
             if r["name"] == "loop.window"}
    windows = fused.iterations // opts.check_every
    assert fused.status == "optimal"
    assert counts == dict({k: 0 for k in counts},
                          fused_dense_steps_kt=windows)
    assert graphs == {"captures": 0, "replays": 0}
    assert modes == {"fused"}

    kernels.reset_launch_counts()
    stepped = stepped_solve(lp, opts, fused.sigma_max)
    counts = kernels.launch_counts()
    assert counts["dual_step"] == stepped.iterations
    assert counts["fused_dense_steps_kt"] == 0
    assert engine.GRAPHS["captures"] == 1
    assert (stepped.iterations, stepped.status) == (fused.iterations,
                                                    fused.status)
    assert float(np.abs(stepped.x - fused.x).max()) <= 1e-8
