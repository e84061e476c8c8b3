"""The port's batched crossbar stream (``CrossbarBatchSolver``,
``solve_crossbar_stream``) against the reference's on a noiseless device
with the reference's programming and solve draws injected (f64 on the
CPU): equal ledgers and equal ``executed_iterations`` (the bucket's
slowest lane, charged to every lane), with and without refinement
rounds, on the decoded operator and on B6; plus the noisy stream's
statistics, the cache and the crossbar batch CLI."""
import dataclasses

import numpy as np
import pytest
import torch
from _torch_parity import (  # noqa: F401  (one_torch_thread: a fixture)
    assert_ledgers_equal,
    noiseless_device,
    one_torch_thread,
    port_options,
    reference,
    reference_batch_draws,
)

from repro_torch.core import engine
from repro_torch.core.pdhg import PDHGOptions
from repro_torch.crossbar import (
    EPIRAM,
    TAOX_HFOX,
    CrossbarBatchSolver,
    encode_core,
    encode_stack,
    solve_crossbar_stream,
)
from repro_torch.interop import device_from_reference, from_reference_lp
from repro_torch.launch import solve as cli
from repro_torch.lp import random_standard_lp

# three lanes in one 64-tile bucket, padded to four with a filler lane
SHAPES = [(8, 14, 0), (7, 12, 1), (9, 13, 2)]


@pytest.fixture(scope="module")
def x64_module():
    jax = pytest.importorskip("jax")
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _both(ref_opts, dev):
    """The reference's and the port's reports on one stream."""
    reference()
    import repro.crossbar as rx
    from repro.lp import random_standard_lp as ref_lp

    lps = [ref_lp(m, n, seed=s) for m, n, s in SHAPES]
    ref = rx.CrossbarBatchSolver(ref_opts, device=dev).solve_stream(lps)
    port = CrossbarBatchSolver(
        port_options(ref_opts), device=device_from_reference(dev),
        torch_device="cpu").solve_stream(
            [from_reference_lp(lp) for lp in lps],
            draws=reference_batch_draws(ref_opts.seed, crossbar_device=dev))
    return ref, port


@pytest.mark.parametrize("rounds", [0, 2], ids=["plain", "refined"])
@pytest.mark.parametrize("kernel", ["jnp", "pallas"],
                         ids=["decoded", "b6"])
def test_crossbar_stream_matches_reference(x64_module, kernel, rounds):
    _, rpdhg = reference()
    import repro.crossbar as rx

    dev = noiseless_device(rx.TAOX_HFOX)
    ref_opts = rpdhg.PDHGOptions(max_iters=512, tol=1e-7, check_every=64,
                                 lanczos_iters=16, kernel=kernel,
                                 refine_rounds=rounds, refine_tol=1e-9)
    ref, port = _both(ref_opts, dev)
    for r, p in zip(ref, port):
        assert p.executed_iterations == r.executed_iterations
        assert p.result.iterations == r.result.iterations
        assert p.result.status == r.result.status
        assert p.pdhg_mvms == r.pdhg_mvms
        assert p.lanczos_mvms == r.lanczos_mvms
        assert p.digital_mvms == r.digital_mvms
        assert p.result.mvm_calls == r.result.mvm_calls
        assert_ledgers_equal(p.ledger, r.ledger)
        np.testing.assert_allclose(p.result.x, r.result.x, rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(p.result.y, r.result.y, rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(p.result.sigma_max, r.result.sigma_max,
                                   rtol=1e-12)
    # one executed count per bucket, window-quantized, the slowest lane's
    assert len({rep.executed_iterations for rep in port}) == 1
    assert port[0].executed_iterations % ref_opts.check_every == 0


def test_crossbar_stream_with_the_reference_programming_draw(x64_module):
    _, rpdhg = reference()
    import repro.crossbar as rx

    dev = dataclasses.replace(rx.TAOX_HFOX, sigma_read=0.0)
    ref_opts = rpdhg.PDHGOptions(max_iters=256, tol=1e-7, check_every=64,
                                 lanczos_iters=16)
    ref, port = _both(ref_opts, dev)
    for r, p in zip(ref, port):
        assert p.executed_iterations == r.executed_iterations
        assert_ledgers_equal(p.ledger, r.ledger)
        np.testing.assert_allclose(p.result.x, r.result.x, rtol=0,
                                   atol=1e-9)


def test_encode_stack_is_encode_core_per_lane():
    g = torch.Generator().manual_seed(0)
    W = torch.randn(3, 64, 64, generator=g, dtype=torch.float64)
    z = tuple(torch.randn(3, 64, 64, generator=g, dtype=torch.float64)
              for _ in range(2))
    gp, gn, scale, nz = encode_stack(W, TAOX_HFOX, z)
    assert gp.shape == (3, 64, 64) and scale.shape == nz.shape == (3,)
    for k in range(3):
        one = encode_core(W[k].clone(), None, TAOX_HFOX.g_levels,
                          TAOX_HFOX.sigma_program,
                          program_draw=(z[0][k], z[1][k]))
        for a, b in zip((gp[k], gn[k], scale[k], nz[k]), one):
            assert torch.equal(a, b)
    # from generators: the lanes draw independently
    gens = [torch.Generator().manual_seed(s) for s in (1, 1, 2)]
    gp, _, _, _ = encode_stack(torch.stack([W[0]] * 3), TAOX_HFOX, gens)
    assert torch.equal(gp[0], gp[1]) and not torch.equal(gp[0], gp[2])


def test_noisy_stream_charges_executed_windows():
    opts = PDHGOptions(max_iters=2000, tol=1e-4, check_every=50)
    lps = [random_standard_lp(8, 14, seed=s) for s in range(3)]
    reports = CrossbarBatchSolver(opts, device=TAOX_HFOX,
                                  torch_device="cpu").solve_stream(lps)
    executed = {rep.executed_iterations for rep in reports}
    assert len(executed) == 1
    exe = executed.pop()
    assert exe == max(rep.result.iterations for rep in reports) \
        or exe > max(rep.result.iterations for rep in reports)
    assert exe % opts.check_every == 0
    assert {rep.pdhg_mvms for rep in reports} == {engine.mvm_accounting(
        exe, opts.check_every, 0, restart=opts.restart)}
    for lp, rep in zip(lps, reports):
        assert rep.ledger.mvm_count == rep.lanczos_mvms + rep.pdhg_mvms
        assert rep.ledger.write_energy_padding_j > 0   # 64-tile bucket
        rel = abs(rep.result.obj - lp.obj_opt) / abs(lp.obj_opt)
        assert rel < 5e-2


def test_crossbar_stream_cache_and_device_key():
    opts = PDHGOptions(max_iters=128, tol=1e-3, check_every=64,
                       lanczos_iters=8)
    solver = CrossbarBatchSolver(opts, device=EPIRAM, torch_device="cpu")
    solver.solve_stream([random_standard_lp(8, 14, seed=0),
                         random_standard_lp(7, 12, seed=1)])
    solver.solve_stream([random_standard_lp(9, 13, seed=2),
                         random_standard_lp(6, 10, seed=3)])
    assert solver.cache_info() == {"hits": 1, "misses": 1, "entries": 1}
    assert solver.last_stream_stats["compiles"] == 0
    other = CrossbarBatchSolver(opts, device=TAOX_HFOX, torch_device="cpu")
    other.solve_stream([random_standard_lp(8, 14, seed=0)])
    assert set(other._cache).isdisjoint(set(solver._cache))


def test_rectangular_tiles_ledger_whole_tiles():
    dev = dataclasses.replace(EPIRAM, name="rect", crossbar_rows=32,
                              crossbar_cols=16)
    opts = PDHGOptions(max_iters=128, tol=1.0, check_every=64,
                       lanczos_iters=4)
    rep = solve_crossbar_stream([random_standard_lp(8, 14, seed=0)], opts,
                                device=dev, torch_device="cpu")[0]
    assert rep.ledger.cells_written == 2 * 64 * 48
    assert rep.ledger.cells_written_padding == 2 * (64 * 48 - (8 + 14) ** 2)


def test_cli_batch_crossbar_stream_on_cpu(capsys):
    reports = cli.main(["--backend", "batch", "--device", "taox",
                        "--kernel", "cuda", "--torch-device", "cpu",
                        "--instances", "rand:8x14,rand:10x18",
                        "--max-iters", "600", "--refine-rounds", "1"])
    out = capsys.readouterr().out.splitlines()
    assert len(reports) == len(out) == 2
    for line in out:
        assert "device=TaOx-HfOx" in line and "| write=" in line
        assert "refine: rounds=1 executed_iters=" in line


@pytest.mark.parametrize("argv,msg", [
    (["--backend", "batch", "--sparse", "--device", "taox"],
     "--sparse does not combine with --device"),
    (["--backend", "exact", "--device", "taox"],
     "--device only applies to --backend batch"),
    (["--backend", "exact", "--sync"], "--sparse/--sync only apply"),
    (["--backend", "batch", "--device", "taox", "--norm-reuse"],
     "--norm-reuse only applies"),
])
def test_cli_batch_option_errors_match_reference(capsys, argv, msg):
    with pytest.raises(SystemExit) as exc:
        cli.main([*argv, "--torch-device", "cpu"])
    assert exc.value.code == 2
    assert msg in capsys.readouterr().err
