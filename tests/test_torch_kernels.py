"""The port's kernels B1-B3 and B6.

On the CPU: each plain version against the reference's Pallas kernel run
in interpret mode (f64 to 1e-15 for the elementwise updates, 1e-12 for a
check window; f32 to 1e-6; B6's in ``test_torch_crossbar.py``), and the
wrappers' rule that only a CPU tensor takes the plain version.  On a card (``cuda`` marker, skipped
without one): each CUDA kernel against its plain version on the same
inputs, and its launch counter.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import pdhg_megakernel as tmk
from repro_torch.kernels import pdhg_update as tupd

# ragged lengths: none is a multiple of 32 or of the reference's 256 block
LENGTHS = (1, 37, 300)
F64 = (np.float64, 1e-15)
F32 = (np.float32, 1e-6)


def _ref_ops():
    pytest.importorskip("jax")
    from repro.kernels import ops

    return ops


def _rng_vecs(seed, d, k, dtype):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.0, 1.0, d).astype(dtype) for _ in range(k)]


def _bounds(seed, d, dtype):
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 3, d)
    lb = np.where(kind == 0, -0.5, np.where(kind == 1, 0.0, -np.inf))
    ub = np.where(kind == 0, 0.5, np.inf)
    return lb.astype(dtype), ub.astype(dtype)


def _close(port, ref, tol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("d", LENGTHS)
@pytest.mark.parametrize("dtype,tol", [F64, F32], ids=["f64", "f32"])
def test_plain_dual_update_matches_pallas(x64, d, dtype, tol):
    ops = _ref_ops()
    y, kx, b = _rng_vecs(d, d, 3, dtype)
    S = np.abs(_rng_vecs(d + 1, d, 1, dtype)[0]) + dtype(0.5)
    sigma = dtype(0.37)
    ref = ops.dual_update(y, kx, b, S, sigma, interpret=True)
    t = [torch.from_numpy(a) for a in (y, kx, b, S)]
    port = tupd.dual_update_plain(*t, torch.tensor(sigma))
    assert port.dtype == t[0].dtype
    _close(port, ref, tol)


@pytest.mark.parametrize("d", LENGTHS)
@pytest.mark.parametrize("dtype,tol", [F64, F32], ids=["f64", "f32"])
def test_plain_primal_update_matches_pallas(x64, d, dtype, tol):
    ops = _ref_ops()
    x, kty, c = _rng_vecs(d, d, 3, dtype)
    T = np.abs(_rng_vecs(d + 1, d, 1, dtype)[0]) + dtype(0.5)
    lb, ub = _bounds(d, d, dtype)
    tau, theta = dtype(0.41), dtype(0.93)
    ref = ops.primal_update(x, kty, c, T, lb, ub, tau, theta,
                            interpret=True)
    t = [torch.from_numpy(a) for a in (x, kty, c, T, lb, ub)]
    port = tupd.primal_update_plain(*t, torch.tensor(tau),
                                    torch.tensor(theta))
    for p, r in zip(port, ref):
        _close(p, r, tol)
    # the box is respected, +-inf bounds included
    assert bool((port[0] >= t[4]).all() and (port[0] <= t[5]).all())


def _window(seed, m, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    K = (rng.normal(size=(m, n)) / np.sqrt(n)).astype(dtype)
    lb, ub = _bounds(seed + 1, n, dtype)
    x = np.clip(rng.uniform(-1.0, 1.0, n), lb, ub).astype(dtype)
    vec = lambda d: rng.uniform(-1.0, 1.0, d).astype(dtype)  # noqa: E731
    pos = lambda d: rng.uniform(0.5, 1.0, d).astype(dtype)   # noqa: E731
    return dict(K=K, K_adj=np.ascontiguousarray(K.T), b=vec(m), c=vec(n),
                lb=lb, ub=ub, T=pos(n), Sigma=pos(m), x=x, x_prev=x.copy(),
                x_bar=x.copy(), y=vec(m), tau=dtype(0.3), sigma=dtype(0.3))


@pytest.mark.parametrize("gamma", [0.0, 0.05])
def test_plain_fused_dense_steps_matches_pallas(x64, gamma):
    pytest.importorskip("jax")
    from repro.kernels import pdhg_megakernel as rmk

    w = _window(7, 7, 11)
    ref = rmk.fused_dense_steps(**w, n_steps=16, gamma=gamma,
                                interpret=True)
    port = tmk.fused_dense_steps_plain(
        **{k: torch.as_tensor(v) for k, v in w.items()},
        n_steps=16, gamma=gamma)
    assert len(port) == len(ref) == 8
    for p, r in zip(port, ref):
        _close(p, r, 1e-12)


def test_wrappers_take_plain_versions_only_for_cpu_tensors():
    w = {k: torch.as_tensor(v) for k, v in _window(3, 5, 9).items()}
    kernels.reset_launch_counts()
    sig = w["sigma"]
    y_new = tupd.dual_update(w["y"], w["b"], w["b"], w["Sigma"], sig)
    torch.testing.assert_close(
        y_new, tupd.dual_update_plain(w["y"], w["b"], w["b"], w["Sigma"],
                                      sig), rtol=0, atol=0)
    tupd.primal_update(w["x"], w["c"], w["c"], w["T"], w["lb"], w["ub"],
                       w["tau"], w["tau"])
    outs = tmk.fused_dense_steps(**w, n_steps=3, gamma=0.0)
    refs = tmk.fused_dense_steps_plain(**w, n_steps=3, gamma=0.0)
    for o, r in zip(outs, refs):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    # plain versions are not launches
    assert kernels.launch_counts() == {"dual_update": 0, "primal_update": 0,
                                       "fused_dense_steps": 0,
                                       "crossbar_mvm": 0}


def test_wrappers_refuse_other_devices():
    v = torch.zeros(4, device="meta")
    s = torch.zeros((), device="meta")
    with pytest.raises(ValueError, match="run on CUDA"):
        tupd.dual_update(v, v, v, v, s)
    with pytest.raises(ValueError, match="run on CUDA"):
        tupd.primal_update(v, v, v, v, v, v, s, s)


# ------------------------------------------------------------ on a card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _on(w, dev, dtype):
    return {k: torch.as_tensor(np.asarray(v), device=dev, dtype=dtype)
            for k, v in w.items()}


def _rel(outs, refs):
    """Largest error of an output over that output's own largest |value|."""
    return max(float((o - r).abs().max()) / float(r.abs().max())
               for o, r in zip(outs, refs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-14),
                                       (torch.float32, 1e-6)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("d", [37, 4096 + 5])
def test_update_kernels_match_plain_on_card(cuda, dtype, tol, d):
    w = _on(_window(d, 4, d), cuda, dtype)
    kx = torch.rand(4, device=cuda, dtype=dtype)
    kty = torch.rand(d, device=cuda, dtype=dtype)
    kernels.reset_launch_counts()
    y_in = w["y"].clone()
    out = tupd.dual_update(w["y"], kx, w["b"], w["Sigma"], w["sigma"])
    assert _rel([out], [tupd.dual_update_plain(
        w["y"], kx, w["b"], w["Sigma"], w["sigma"])]) <= tol
    assert torch.equal(w["y"], y_in)
    theta = torch.full((), 0.93, device=cuda, dtype=dtype)
    outs = tupd.primal_update(w["x"], kty, w["c"], w["T"], w["lb"], w["ub"],
                              w["tau"], theta)
    refs = tupd.primal_update_plain(w["x"], kty, w["c"], w["T"], w["lb"],
                                    w["ub"], w["tau"], theta)
    assert _rel(outs, refs) <= tol
    torch.cuda.synchronize()
    assert kernels.launch_counts() == {"dual_update": 1, "primal_update": 1,
                                       "fused_dense_steps": 0,
                                       "crossbar_mvm": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("gamma", [0.0, 0.05])
def test_fused_kernel_matches_plain_on_card(cuda, dtype, tol, gamma):
    w = _on(_window(11, 333, 517), cuda, dtype)
    before = {k: v.clone() for k, v in w.items()}
    kernels.reset_launch_counts()
    outs = tmk.fused_dense_steps(**w, n_steps=100, gamma=gamma)
    refs = tmk.fused_dense_steps_plain(**w, n_steps=100, gamma=gamma)
    assert _rel(outs, refs) <= tol
    assert all(torch.equal(w[k], before[k]) for k in w)
    assert kernels.launch_counts()["fused_dense_steps"] == 1


@pytest.mark.cuda
def test_kernels_refuse_mixed_operands(cuda):
    v = torch.zeros(8, device=cuda)
    s = torch.zeros((), device=cuda)
    with pytest.raises(TypeError):
        tupd.dual_update(v, v.double(), v, v, s)
    with pytest.raises(TypeError, match="0-d tensors"):
        tupd.dual_update(v, v, v, v, 0.5)


# B6: tolerance over each output's largest |value|; the kernel sums a
# row in warp-strided order, the plain version in cuBLAS's, over up to
# 2048 terms here (11520 in chip_smoke.py, with the same bounds)
B6_TOLS = [(torch.float64, 1e-13), (torch.float32, 1e-5)]


def _b6(dev, dtype, shape, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    R, C = shape[-2:]
    lead = shape[:-2]
    gp = torch.rand(shape, generator=g, dtype=dtype, device=dev)
    gn = torch.rand(shape, generator=g, dtype=dtype, device=dev)
    v = torch.randn((*lead, C), generator=g, dtype=dtype, device=dev)
    noise = 1e-3 * torch.randn((*lead, R), generator=g, dtype=dtype,
                               device=dev)
    return gp, gn, v, noise


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", B6_TOLS, ids=["f64", "f32"])
@pytest.mark.parametrize("shape", [(777, 1235), (1, 3), (512, 2048),
                                   (3, 777, 1235), (3, 256, 2048)],
                         ids=["ragged", "tiny", "aligned", "batch3-ragged",
                              "batch3-aligned"])
def test_crossbar_mvm_kernel_matches_plain_on_card(cuda, dtype, tol, shape):
    from repro_torch.kernels import crossbar_mvm as xb

    gp, gn, v, noise = _b6(cuda, dtype, shape)
    scale = (torch.tensor([0.5, 1.0, 2.0], dtype=dtype, device=cuda)
             if len(shape) == 3 else 0.83)
    kernels.reset_launch_counts()
    out = xb.crossbar_mvm(gp, gn, v, scale, noise)
    ref = xb.crossbar_mvm_plain(gp, gn, v, scale, noise)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert _rel([out], [ref]) <= tol
    assert kernels.launch_counts()["crossbar_mvm"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", B6_TOLS, ids=["f64", "f32"])
def test_crossbar_mvm_kernel_zero_padding_is_inert(cuda, dtype, tol):
    from repro_torch.kernels import crossbar_mvm as xb

    gp, gn, v, noise = _b6(cuda, dtype, (300, 500), seed=1)
    base = xb.crossbar_mvm(gp, gn, v, 0.7, noise)
    pad = torch.nn.functional.pad
    out = xb.crossbar_mvm(pad(gp, (0, 12, 0, 84)), pad(gn, (0, 12, 0, 84)),
                          pad(v, (0, 12)), 0.7, pad(noise, (0, 84)))
    torch.cuda.synchronize()
    assert _rel([out[:300]], [base]) <= tol
    assert torch.all(out[300:] == 0.0)


@pytest.mark.cuda
def test_crossbar_mvm_kernel_refuses_bad_operands(cuda):
    from repro_torch.kernels import crossbar_mvm as xb

    gp, gn, v, noise = _b6(cuda, torch.float64, (8, 16))
    with pytest.raises(ValueError, match="v must be"):
        xb.crossbar_mvm(gp, gn, v[:5], 1.0, noise)
    with pytest.raises(TypeError):
        xb.crossbar_mvm(gp, gn.float(), v, 1.0, noise)
    with pytest.raises(ValueError, match="contiguous"):
        xb.crossbar_mvm(gp.T, gn.T, v[:8], 1.0, torch.zeros(
            16, dtype=torch.float64, device=cuda))
