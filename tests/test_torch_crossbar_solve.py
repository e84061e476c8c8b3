"""The port's ``solve_crossbar_jit`` and its refinement shell against the
reference (noiseless device variant, the reference's draws injected,
f64 on the CPU), the refinement experiment of ``BENCH_stream.json`` by
its statistics, the crossbar CLI, and the paper's energy factors."""
import dataclasses

import numpy as np
import pytest
from _torch_parity import (
    assert_ledgers_equal,
    assert_matches,
    noiseless_device,
    port_options,
    reference,
    reference_draws,
)

from repro_torch.core import engine
from repro_torch.core.pdhg import PDHGOptions, solve_jit
from repro_torch.crossbar import (
    EPIRAM,
    RTX6000,
    TAOX_HFOX,
    Ledger,
    solve_crossbar_jit,
)
from repro_torch.interop import device_from_reference, from_reference_lp
from repro_torch.launch import solve as cli
from repro_torch.lp import random_standard_lp


def _ref_crossbar():
    reference()
    import repro.crossbar as rx

    return rx


def _both(lp, dev_name, **kw):
    """The reference's and the port's report on one noiseless device."""
    import jax

    rx = _ref_crossbar()
    _, rpdhg = reference()
    ref_dev = noiseless_device(getattr(rx, dev_name))
    ref_opts = rpdhg.PDHGOptions(**kw)
    ref = rx.solve_crossbar_jit(lp, ref_opts, device=ref_dev,
                                key=jax.random.PRNGKey(0))
    port = solve_crossbar_jit(from_reference_lp(lp), port_options(ref_opts),
                              device=device_from_reference(ref_dev), seed=0,
                              torch_device="cpu",
                              draws=reference_draws(lp, ref_opts))
    return port, ref


def assert_reports_match(port, ref):
    assert_matches(port.result, ref.result)
    for f in ("lanczos_mvms", "pdhg_mvms", "executed_iterations",
              "digital_mvms"):
        assert getattr(port, f) == getattr(ref, f), f
    assert_ledgers_equal(port.ledger, ref.ledger)
    assert port.ledger.mvm_count == port.result.mvm_calls


@pytest.mark.parametrize("dev_name", ["TAOX_HFOX", "EPIRAM"])
def test_solve_crossbar_jit_matches_reference(x64, dev_name):
    lp = random_standard_lp(16, 28, seed=2)
    port, ref = _both(lp, dev_name, max_iters=3000, tol=1e-6,
                      check_every=100, lanczos_iters=32)
    assert_reports_match(port, ref)
    # the programmed operator, not the nominal one, was solved: the
    # quantization error is visible in the objective
    assert port.result.obj != pytest.approx(lp.obj_opt, rel=1e-9)


def test_solve_crossbar_jit_with_the_reference_programming_draw(x64):
    """Programming noise on, read noise off: with the reference's two
    programming draws injected (``encode_core``'s fault-free path draws
    normal(k1), normal(k2), k1, k2 = split(key), on the tile-padded M)
    the port programs the same conductances and solves the same LP."""
    import jax

    rx = _ref_crossbar()
    _, rpdhg = reference()
    lp = random_standard_lp(16, 28, seed=2)
    ref_dev = dataclasses.replace(rx.TAOX_HFOX, sigma_read=0.0)
    ref_opts = rpdhg.PDHGOptions(max_iters=2000, tol=1e-6, check_every=100,
                                 lanczos_iters=32)
    key = jax.random.PRNGKey(5)
    ref = rx.solve_crossbar_jit(lp, ref_opts, device=ref_dev, key=key)
    side = 64                       # (16 + 28) padded to one 64-tile
    draw = tuple(np.array(jax.random.normal(k, (side, side)))
                 for k in jax.random.split(key))
    port = solve_crossbar_jit(from_reference_lp(lp), port_options(ref_opts),
                              device=device_from_reference(ref_dev),
                              torch_device="cpu", program_draw=draw,
                              draws=reference_draws(lp, ref_opts))
    assert_reports_match(port, ref)


def test_solve_crossbar_refined_matches_reference(x64):
    lp = random_standard_lp(12, 20, seed=1)
    port, ref = _both(lp, "TAOX_HFOX", max_iters=1024, tol=1e-7,
                      check_every=64, refine_rounds=2, refine_tol=1e-8)
    assert_reports_match(port, ref)
    assert port.digital_mvms == engine.refine_digital_mvms(2) == 6
    assert port.executed_iterations == port.result.iterations


@pytest.fixture(scope="module")
def refinement_experiment():
    """``benchmarks/stream_throughput.py``'s refinement experiment: EpiRAM
    at sigma_read = 2e-3, 8000 iterations, a check every 64, 4 rounds to
    refine_tol = 1e-6, on the port with its own draws."""
    lp = random_standard_lp(16, 28, seed=3)
    dev = dataclasses.replace(EPIRAM, sigma_read=2e-3)
    opts = PDHGOptions(max_iters=8000, tol=1e-6, check_every=64)
    plain = solve_crossbar_jit(lp, opts, device=dev, torch_device="cpu")
    refined = solve_crossbar_jit(
        lp, dataclasses.replace(opts, refine_rounds=4, refine_tol=1e-6),
        device=dev, torch_device="cpu")
    return plain, refined


def test_refinement_reaches_tol_where_the_single_solve_stalls(
        refinement_experiment):
    plain, refined = refinement_experiment
    # the single analog pass sits at the read-noise floor (about 4e-3 in
    # the reference's record)
    assert plain.result.status == "iteration_limit"
    assert 5e-4 <= plain.result.merit <= 5e-2
    assert refined.result.status == "optimal"
    assert refined.result.merit <= 1e-6


def test_refinement_writes_nothing_and_charges_every_read(
        refinement_experiment):
    plain, refined = refinement_experiment
    for f in ("cells_written", "write_energy_j", "write_latency_s"):
        assert getattr(refined.ledger, f) == getattr(plain.ledger, f), f
    assert refined.pdhg_mvms > plain.pdhg_mvms
    assert refined.ledger.mvm_count == (refined.lanczos_mvms
                                        + refined.pdhg_mvms)
    assert refined.digital_mvms == engine.refine_digital_mvms(4) == 10
    assert plain.digital_mvms == 0


def test_crossbar_solve_reaches_the_noise_floor_band():
    """test_crossbar's noise-floor check, ported (TaOx-HfOx with its
    noise, the objective judged against ``lp.obj_opt``)."""
    lp = random_standard_lp(16, 28, seed=4)
    rep = solve_crossbar_jit(
        lp, PDHGOptions(max_iters=15000, tol=1e-5, check_every=100,
                        lanczos_iters=32), device=TAOX_HFOX,
        torch_device="cpu")
    assert abs(rep.result.obj - lp.obj_opt) / abs(lp.obj_opt) < 5e-3
    assert rep.ledger.total_energy_j > 0
    assert rep.ledger.mvm_count == rep.result.mvm_calls


def test_energy_factors_match_paper_magnitudes():
    """test_system's headline check on the port's own ledger and the
    analytic RTX6000 model: 10x..5000x energy, more than 1x latency."""
    lp = random_standard_lp(24, 41, seed=3)
    m, n = lp.K.shape
    opts = PDHGOptions(max_iters=15000, tol=1e-5, check_every=100,
                       lanczos_iters=32)
    rep = solve_crossbar_jit(lp, opts, device=TAOX_HFOX, torch_device="cpu")
    res = solve_jit(lp, opts, device="cpu")
    gpu = Ledger()
    RTX6000.h2d(8 * (m * n + m + n), gpu)
    for _ in range(res.iterations):
        RTX6000.pdhg_iteration(m, n, gpu)
    assert gpu.total_energy_j / rep.ledger.total_energy_j > 10
    assert gpu.total_latency_s / rep.ledger.total_latency_s > 1


@pytest.mark.parametrize("args,line", [
    (["--backend", "taox"], "energy: write="),
    (["--backend", "epiram", "--refine-rounds", "2"], "refine: rounds=2"),
    (["--backend", "taox", "--ecc", "3"], "ecc: k=3 decode=median"),
], ids=["taox", "epiram-refine", "taox-ecc"])
def test_cli_crossbar_backends_on_cpu(capsys, args, line):
    res = cli.main([*args, "--torch-device", "cpu", "--max-iters", "1000",
                    "--tol", "1e-4"])
    out = capsys.readouterr().out
    assert line in out
    assert "instance=gen-ip002" in out and f"status={res.status}" in out
    lp = cli.load_instance("gen-ip002")
    assert abs(res.obj - lp.obj_opt) / abs(lp.obj_opt) < 5e-2


@pytest.mark.parametrize("args", [
    ["--refine-rounds", "2"], ["--refine-tol", "1e-6"], ["--ecc", "3"],
    ["--backend", "taox", "--ecc", "0"],
], ids=["refine-exact", "refine-tol-exact", "ecc-exact", "ecc-0"])
def test_cli_errors_match_reference(capsys, args):
    reference()
    from repro.launch import solve as rcli

    messages = []
    for main in (rcli.main, cli.main):
        with pytest.raises(SystemExit) as exc:
            main(args)
        assert exc.value.code == 2
        messages.append(capsys.readouterr().err.split("error: ", 1)[1])
    assert messages[0] == messages[1]
