"""Quantized collectives (``repro_torch.distributed.compression``), the
stacked-batch path (``distributed.batch_solve``) and the batch solvers'
``mesh=``, held against the reference on one rank and run over two gloo
ranks on the CPU."""
import numpy as np
import pytest
import torch
from _torch_dist_harness import mesh_streams, run_ranks, stream_arrays

from repro_torch.core.pdhg import PDHGOptions
from repro_torch.distributed import (
    compressed_psum,
    dequantize_int8,
    quantize_int8,
    solve_batch,
    stack_problems,
)
from repro_torch.distributed.compression import _stochastic_round
from repro_torch.lp import random_standard_lp
from repro_torch.runtime.mesh import make_mesh

BATCH_OPTS = dict(max_iters=20000, tol=1e-6, check_every=64)
BATCH = [[8, 14, 0], [8, 14, 1], [8, 14, 2], [8, 14, 3]]


def _x(n=256, seed=0, scale=3.0):
    return torch.as_tensor(np.random.default_rng(seed).normal(
        scale=scale, size=n), dtype=torch.float32)


def test_quantize_int8_matches_reference():
    """The same int8 grid and scale as the reference's, and within half
    a step everywhere (the extreme element maps to +-127)."""
    import jax.numpy as jnp

    from repro.distributed import quantize_int8 as ref_quantize

    x = _x()
    q, scale = quantize_int8(x)
    rq, rscale = ref_quantize(jnp.asarray(x.numpy()))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert float(scale) == float(rscale)
    err = (dequantize_int8(q, scale) - x).abs()
    assert float(err.max()) <= 0.5 * float(scale) * (1 + 1e-6)
    assert abs(int(q[int(torch.argmax(x.abs()))])) == 127


def test_quantize_roundtrip_exact_on_grid():
    ints = torch.arange(-127, 128, dtype=torch.float32)
    q, scale = quantize_int8(ints)
    np.testing.assert_array_equal(q.numpy(), np.arange(-127, 128))
    np.testing.assert_allclose(dequantize_int8(q, scale).numpy(),
                               ints.numpy(), rtol=1e-6)


def test_stochastic_round_is_unbiased():
    x = torch.tensor([0.25, 1.75, -2.4, 3.0, -0.1])
    g = torch.Generator().manual_seed(0)
    rounded = torch.stack([_stochastic_round(x, g) for _ in range(4096)])
    assert torch.all(rounded[:, 3] == 3.0)
    np.testing.assert_allclose(rounded.mean(0).numpy(), x.numpy(),
                               atol=0.05)


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_compressed_psum_one_rank_matches_reference(bits):
    """On one rank the quantized sum equals the reference's on its
    one-device axis bit for bit, within half a step of the global
    scale."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from repro.distributed import compressed_psum as ref_psum
    from repro.runtime import compat
    from repro.runtime.mesh import make_mesh as ref_mesh

    x = _x(seed=1)
    out = compressed_psum(x, None, bits=bits)
    ref = compat.shard_map(lambda v: ref_psum(v, "data", bits=bits),
                           mesh=ref_mesh({"data": 1}), in_specs=(P(),),
                           out_specs=P(), check_vma=False)(
        jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    scale = float(x.abs().max()) / (2.0 ** (bits - 1) - 1.0)
    assert float((out - x).abs().max()) <= 0.5 * scale * (1 + 1e-5)


def test_compressed_psum_int32_accumulation_is_exact():
    x = _x(seed=4)
    q, scale = quantize_int8(x)
    assert torch.equal(compressed_psum(x, None, bits=8),
                       q.to(torch.float32) * scale)


def test_solve_batch_one_rank(x64):
    """Each lane of a stack solved on one rank reaches the known optimum;
    a stack the mesh cannot split, or whose arrays disagree, raises."""
    mesh = make_mesh({"data": 1}, device="cpu")
    lps = [random_standard_lp(m, n, seed=s) for m, n, s in BATCH]
    Ks, bs, cs, lbs, ubs = stack_problems(lps)
    out = solve_batch(Ks, bs, cs, lbs, ubs, mesh, PDHGOptions(**BATCH_OPTS))
    objs = np.einsum("bn,bn->b", cs, out["x"])
    for lp, obj, ok in zip(lps, objs, out["converged"]):
        assert ok and abs(obj - lp.obj_opt) / abs(lp.obj_opt) < 1e-4
    with pytest.raises(ValueError):
        solve_batch(Ks[:1], bs, cs, lbs, ubs, mesh,
                    PDHGOptions(**BATCH_OPTS))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("coll2"))
    return run_ranks(2, "collectives",
                     {"batch": BATCH, "opts": BATCH_OPTS}, d, timeout=240)


def test_compressed_psum_two_ranks(two_ranks):
    """Over two gloo ranks: each rank's rounding error is at most half a
    step of the GLOBAL scale, so the sum is within two half steps of the
    exact all-reduce; more bits, a finer grid; stochastic rounding is
    unbiased over 64 draws."""
    exact = two_ranks[0]["exact"]
    np.testing.assert_array_equal(
        exact, two_ranks[0]["x"] + two_ranks[1]["x"])
    amax = max(np.abs(r["x"]).max() for r in two_ranks)
    errs = {}
    for bits in (4, 8, 16):
        scale = amax / (2.0 ** (bits - 1) - 1.0)
        out = two_ranks[0][f"q{bits}"]
        np.testing.assert_array_equal(out, two_ranks[1][f"q{bits}"])
        errs[bits] = np.abs(out - exact).max()
        assert errs[bits] <= 2 * 0.5 * scale * (1 + 1e-5), bits
    assert errs[16] < errs[8] < errs[4]
    scale = amax / 31.0
    np.testing.assert_allclose(two_ranks[0]["stochastic"].mean(0), exact,
                               atol=0.5 * scale)


def test_solve_batch_two_ranks_equals_one(two_ranks, x64):
    """Lanes split over two ranks give the one-rank results (lane seeds
    come from global positions): every rank returns the whole batch."""
    mesh = make_mesh({"data": 1}, device="cpu")
    lps = [random_standard_lp(m, n, seed=s) for m, n, s in BATCH]
    one = solve_batch(*stack_problems(lps), mesh, PDHGOptions(**BATCH_OPTS))
    for r in two_ranks:
        np.testing.assert_array_equal(r["batch/iterations"],
                                      one["iterations"])
        np.testing.assert_allclose(r["batch/x"], one["x"], rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(r["batch/y"], one["y"], rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("name", ["stream", "crossbar"])
def test_batch_solvers_split_lanes_over_two_ranks(two_ranks, name):
    """``BatchSolver(mesh=)`` and ``CrossbarBatchSolver(mesh=)`` over two
    ranks (each bucket padded to an even batch, half its lanes a rank,
    gathered in bucket order) give every rank one process's results."""
    one = stream_arrays(mesh_streams()[name])
    for r in two_ranks:
        np.testing.assert_array_equal(r[f"{name}/iterations"],
                                      one["iterations"])
        for k in ("x_cat", "y_cat", "merits"):
            np.testing.assert_allclose(r[f"{name}/{k}"], one[k], rtol=0,
                                       atol=1e-12, err_msg=k)
