"""Exit semantics, option checks, read noise, the device rule and the
CLI of the port's ``solve_jit``, against the reference where it has the
same behaviour (f64 on the CPU, reference draws injected)."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from _torch_parity import (
    assert_matches,
    port_solve,
    reference,
    reference_solve,
)

from repro_torch.core import engine as te
from repro_torch.core import pdhg as tp
from repro_torch.launch import solve as cli
from repro_torch.lp import assignment_lp, random_standard_lp, table1_instance


def test_loop_overshoots_max_iters_to_the_next_boundary(x64):
    lp = random_standard_lp(10, 18, seed=6)
    ref_opts, ref = reference_solve(lp, max_iters=4000, check_every=64)
    port = port_solve(lp, ref_opts)
    assert ref.iterations == port.iterations == 4032
    assert port.status == ref.status == "iteration_limit"
    assert_matches(port, ref)


@pytest.mark.parametrize("kw", [{"eta": 5.0}, {"norm_override": 1e-3}],
                         ids=["eta-5", "norm-1e-3"])
def test_non_finite_merit_reports_diverged(x64, kw):
    # steps far past the Lemma 2 coupling blow the iterate up to NaN
    lp = random_standard_lp(12, 20, seed=3)
    ref_opts, ref = reference_solve(lp, max_iters=2000, **kw)
    port = port_solve(lp, ref_opts)
    assert ref.status == port.status == "diverged"
    assert port.iterations == ref.iterations < 2000
    assert port.mvm_calls == ref.mvm_calls and not np.isfinite(port.merit)


@pytest.mark.parametrize("bad", [
    {"kernel": "pallas"}, {"sparse_kernel": "csr"},
    {"megakernel": True, "sigma_read": 1e-3}, {"step_rule": "nesterov"},
    {"step_rule": "strongly_convex"}, {"gamma": 0.1},
    {"refine_rounds": -1}, {"norm_backend": "qr"},
])
def test_option_errors_match_reference(x64, bad):
    _, rpdhg = reference()
    bad = dict(bad)
    sigma_read = bad.pop("sigma_read", 0.0)
    lp = assignment_lp(3)
    ref_kw = {k: ("bogus" if k == "kernel" else v) for k, v in bad.items()}
    with pytest.raises(ValueError) as ref_err:
        rpdhg.solve_jit(lp, rpdhg.PDHGOptions(**ref_kw), sigma_read=sigma_read)
    with pytest.raises(ValueError) as port_err:
        tp.solve_jit(lp, tp.PDHGOptions(**bad), sigma_read=sigma_read,
                     device="cpu")
    if "kernel" not in bad:
        assert str(port_err.value) == str(ref_err.value)
    else:
        assert "unknown update kernel 'pallas'" in str(port_err.value)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.solve_jit(assignment_lp(3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.solve_jit(assignment_lp(3), device="cuda")


def test_read_noise_is_unit_mean_truncated_gaussian():
    sigma_read = 0.05
    g = torch.Generator().manual_seed(0)
    w = torch.full((400_000,), 2.0, dtype=torch.float64)
    noisy = te._read_noise(w, g, sigma_read)
    z = (noisy / w - 1.0) / sigma_read          # the drawn N(0,1), clipped
    assert abs(float(z.mean())) < 0.01
    assert abs(float(z.std()) - 1.0) < 0.01
    assert float(z.abs().max()) <= 4.0 + 1e-9
    assert int((z.abs() > 4.0 - 1e-9).sum()) > 0      # the clip is reached


def test_noisy_solve_draws_from_its_generator(x64):
    lp = table1_instance("gen-ip002")
    opts = tp.PDHGOptions(max_iters=3000, check_every=100)
    a = tp.solve_jit(lp, opts, sigma_read=1e-3, device="cpu")
    b = tp.solve_jit(lp, opts, sigma_read=1e-3, device="cpu")
    c = tp.solve_jit(lp, dataclasses.replace(opts, seed=1), sigma_read=1e-3,
                     device="cpu")
    np.testing.assert_array_equal(a.x, b.x)     # same seed, same draws
    assert not np.array_equal(a.x, c.x)
    assert abs(a.obj - lp.obj_opt) / abs(lp.obj_opt) < 1e-2


def test_cli_solves_the_default_instance_on_cpu():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve",
         "--torch-device", "cpu"],
        capture_output=True, text=True, env=env, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert "instance=gen-ip002" in out.stdout
    assert "status=optimal" in out.stdout


@pytest.mark.parametrize("argv,item", [
    (["--backend", "distributed"], "A6"),
    (["--backend", "batch", "--pods", "2"], "A6"),
    (["--backend", "batch", "--cluster", "auto"], "A6"),
], ids=["distributed-A6", "batch-pods-A6", "batch-cluster-A6"])
def test_cli_names_the_roadmap_item_of_unported_backends(capsys, argv, item):
    """ROADMAP item A6 ported these: the distributed backend and the
    cluster flags no longer exit naming the item, and each solves the
    default instance on the CPU (``--pods 2`` through a virtual pod,
    ``--cluster auto`` without a cluster env in one process)."""
    from repro_torch.runtime import cluster

    cluster._reset_for_tests()
    try:
        out = cli.main([*argv, "--torch-device", "cpu"])
    finally:
        cluster._reset_for_tests()
    res = out[0] if isinstance(out, list) else out
    assert res.status == "optimal"
    captured = capsys.readouterr()
    assert f"ROADMAP item {item}" not in captured.err
    assert ("cluster: pod=0/2" in captured.out) == ("--pods" in argv)
