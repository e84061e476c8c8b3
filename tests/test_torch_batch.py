"""Bucketed batch serving of the port (``repro_torch.runtime.batch``)
against the reference (f64 on the CPU, the reference's per-lane draws
injected): the numpy bucketing and stacking helpers, the dense bucket
pipeline on every step rule x restart, ``BatchSolver.solve_stream`` on a
mixed stream, and the ports of the reference's serving checks (cache,
async, per-lane streams, norm reuse, warm streams), plus the batched
norm estimate and the batch CLI."""
import dataclasses
import os
import subprocess
import sys

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

from repro_torch.core import engine
from repro_torch.core.lanczos import (
    lanczos_svd_jit_mv,
    power_iteration_mv,
    tridiag_radius,
)
from repro_torch.core.pdhg import PDHGOptions, solve_jit
from repro_torch.interop import from_reference_lp
from repro_torch.lp import StandardLP, random_standard_lp
from repro_torch.runtime import BatchSolver, CompileGuard, RecompileError
from repro_torch.runtime import batch as tb
from repro_torch.runtime import sanitize

STREAM = [(8, 14, 0), (10, 18, 1), (20, 34, 2), (7, 13, 3)]


def _ref_batch():
    reference()
    from repro.runtime import batch as rb

    return rb


@pytest.fixture(scope="module")
def x64_module():
    jax = pytest.importorskip("jax")
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def _stream():
    return [random_standard_lp(m, n, seed=s) for m, n, s in STREAM]


# ---------------------------------------------------- numpy host layer ---

@pytest.mark.parametrize("m,n,tile", [(8, 14, None), (9, 16, None),
                                      (1, 1, None), (129, 300, None),
                                      (8, 70, (64, 64)), (65, 1, (64, 32)),
                                      (20, 70, (64, 64))])
def test_bucket_dims_match_reference(m, n, tile):
    rb = _ref_batch()
    assert tb.bucket_dims(m, n, tile=tile) == rb.bucket_dims(m, n, tile=tile)


@pytest.mark.parametrize("nnz", [0, 1, 15, 16, 17, 1000])
def test_nnz_bucket_matches_reference(nnz):
    assert tb.nnz_bucket(nnz) == _ref_batch().nnz_bucket(nnz)


def test_pad_and_stack_match_reference():
    rb = _ref_batch()
    lps = _stream()
    p, r = tb.pad_problem(lps[0], 16, 32), rb.pad_problem(lps[0], 16, 32)
    for f in ("K", "b", "c", "lb", "ub", "x_opt"):
        np.testing.assert_array_equal(getattr(p, f), getattr(r, f))
        assert getattr(p, f).dtype == getattr(r, f).dtype
    for a, b in zip(tb.stack_problems(lps), rb.stack_problems(lps)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tb.stack_problems(lps[:2], m=16, n=32),
                    rb.stack_problems(lps[:2], m=16, n=32)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


# ------------------------------------------------ the dense pipeline ---

def _bucket(lps, mb, nb, B):
    """The reference's stacking of one bucket (filler repeats lane 0)."""
    rb = _ref_batch()
    group = lps + [lps[0]] * (B - len(lps))
    return rb.stack_problems(group, m=mb, n=nb)


def _run_port_pipeline(make, port_opts, arrays, mb, nb, B, n_total,
                       int_fields=()):
    """The port's pipeline on the reference's stacked arrays with the
    reference's draws injected; (outputs as numpy, windows)."""
    solver = BatchSolver(port_opts, torch_device="cpu")
    idxs = list(range(min(B, n_total)))
    keys = solver._instance_keys(idxs, n_total, B)
    positions = idxs + [n_total + j for j in range(B - len(idxs))]
    draws = solver._lane_draws(keys, positions, mb, nb, torch.float64,
                               reference_batch_draws(port_opts.seed))
    tensors = [torch.as_tensor(np.asarray(a), dtype=torch.int32
                               if i in int_fields else torch.float64)
               for i, a in enumerate(arrays)]
    out, windows = engine.drain(make(port_opts, device="cpu").run(
        tensors, draws))
    return [t.numpy() for t in out], windows


def _run_ref_pipeline(make, ref_opts, arrays, B, n_total):
    import jax

    rb = _ref_batch()
    keys = rb.BatchSolver(ref_opts)._instance_keys(
        list(range(min(B, n_total))), n_total, B)
    out = jax.jit(make(ref_opts))(*arrays, keys)
    return [np.asarray(a) for a in out]


def assert_pipeline_outputs_match(port, ref, check_every):
    """Per lane: x/y to 1e-10, iterations (and so the MVM charge) equal,
    the merit to rtol 1e-8 and the raw norm estimate to rtol 1e-12."""
    xs, ys, its, merits, rhos = port[:5]
    np.testing.assert_allclose(xs, ref[0], rtol=0, atol=1e-10)
    np.testing.assert_allclose(ys, ref[1], rtol=0, atol=1e-10)
    np.testing.assert_array_equal(its, ref[2])
    for it in its:
        assert engine.mvm_accounting(int(it), check_every, 8) > 0
    np.testing.assert_allclose(merits, ref[3], rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(rhos, ref[4], rtol=1e-12)


PIPE_OPTS = dict(max_iters=256, tol=1e-5, check_every=64, lanczos_iters=8)


@pytest.mark.parametrize("restart", [True, False],
                         ids=["restart", "norestart"])
@pytest.mark.parametrize("rule", list(RULES))
def test_dense_bucket_pipeline_matches_reference(x64_module, rule, restart):
    rb = _ref_batch()
    _, rpdhg = reference()
    lps = _stream()[:3]
    ref_opts = rpdhg.PDHGOptions(step_rule=rule, gamma=RULES[rule],
                                 restart=restart, **PIPE_OPTS)
    arrays = _bucket(lps, 32, 64, 4)
    ref = _run_ref_pipeline(rb.make_bucket_pipeline, ref_opts, arrays, 4, 3)
    port, windows = _run_port_pipeline(
        tb.make_bucket_pipeline, port_options(ref_opts), arrays, 32, 64, 4,
        3)
    assert_pipeline_outputs_match(port, ref, ref_opts.check_every)
    # every lane ran while any lane was active
    assert windows * ref_opts.check_every == int(np.max(ref[2]))


# ------------------------------------------------------ solve_stream ---

@pytest.fixture(scope="module")
def mixed_stream(x64_module):
    """The reference's and the port's ``solve_stream`` on a mixed dense
    stream (three buckets, one with a filler lane)."""
    rb = _ref_batch()
    _, rpdhg = reference()
    lps = _stream()
    ref_opts = rpdhg.PDHGOptions(max_iters=2000, tol=1e-4, check_every=64,
                                 lanczos_iters=16)
    ref = rb.BatchSolver(ref_opts).solve_stream(lps)
    solver = BatchSolver(port_options(ref_opts), torch_device="cpu")
    port = solver.solve_stream([from_reference_lp(lp) for lp in lps],
                               draws=reference_batch_draws(0))
    return lps, ref_opts, ref, port, solver


def test_solve_stream_matches_reference(mixed_stream):
    lps, _, ref, port, _ = mixed_stream
    for lp, r, p in zip(lps, ref, port):
        assert p.name == r.name and p.bucket == r.bucket
        assert p.status == r.status == "optimal"
        assert p.iterations == r.iterations
        assert p.mvm_calls == r.mvm_calls
        np.testing.assert_allclose(p.x, r.x, rtol=0, atol=1e-10)
        np.testing.assert_allclose(p.y, r.y, rtol=0, atol=1e-10)
        np.testing.assert_allclose(p.merit, r.merit, rtol=1e-8)
        assert p.x.shape == (lp.K.shape[1],)


def test_solve_stream_records_stream_stats(mixed_stream):
    *_, solver = mixed_stream
    st = solver.last_stream_stats
    assert st["n_buckets"] == 3
    assert st["dense_stack_bytes"] > 0 and st["sparse_stack_bytes"] == 0
    assert st["dispatch_s"] >= 0 and st["collect_s"] >= 0
    assert st["compiles"] == 3 and st["donated_buckets"] == 0
    assert sorted(b["lanes"] for b in st["bucket_windows"]) == [1, 1, 2]


def test_solve_stream_matches_single_solves():
    opts = PDHGOptions(max_iters=20000, tol=1e-6, check_every=64)
    lps = _stream()
    port = BatchSolver(opts, torch_device="cpu").solve_stream(lps)
    assert [r.name for r in port] == [lp.name for lp in lps]
    for lp, r in zip(lps, port):
        assert r.converged, (lp.K.shape, r.merit)
        single = solve_jit(lp, opts, device="cpu")
        assert abs(r.obj - single.obj) / max(abs(single.obj), 1e-12) < 1e-4
        assert abs(r.obj - lp.obj_opt) / abs(lp.obj_opt) < 1e-4


def test_solve_stream_async_matches_sync():
    opts = PDHGOptions(max_iters=2000, tol=1e-4, check_every=64,
                       lanczos_iters=16)
    lps = _stream()
    r_async = BatchSolver(opts, torch_device="cpu").solve_stream(lps)
    r_sync = BatchSolver(opts, async_dispatch=False,
                         torch_device="cpu").solve_stream(lps)
    for a, s in zip(r_async, r_sync):
        assert a.name == s.name and a.iterations == s.iterations
        np.testing.assert_array_equal(a.x, s.x)
        assert a.merit == s.merit


def test_solve_stream_cache_hits_on_repeat_shapes():
    opts = PDHGOptions(max_iters=512, tol=1e-4, check_every=64,
                       lanczos_iters=16)
    solver = BatchSolver(opts, torch_device="cpu")
    solver.solve_stream([random_standard_lp(8, 14, seed=0),
                         random_standard_lp(7, 13, seed=1)])
    assert solver.cache_info() == {"hits": 0, "misses": 1, "entries": 1}
    # same bucket, same batch size, new instances: the pipeline is reused
    with CompileGuard(max_compiles=0) as guard:
        solver.solve_stream([random_standard_lp(6, 12, seed=2),
                             random_standard_lp(8, 15, seed=3)])
    assert guard.compiles == 0 and solver.last_stream_stats["compiles"] == 0
    assert solver.cache_hits == 1 and solver.cache_misses == 1
    # a genuinely new bucket still builds, and a guard of 0 says so
    with pytest.raises(RecompileError, match="cache miss"):
        with CompileGuard(max_compiles=0):
            solver.solve_stream([random_standard_lp(20, 40, seed=4)] * 2)
    assert solver.cache_misses == 2


def test_cache_key_carries_the_reference_fields():
    opts = PDHGOptions()
    fixed = BatchSolver(opts, torch_device="cpu")
    adaptive = BatchSolver(dataclasses.replace(opts, step_rule="adaptive"),
                           torch_device="cpu")
    k1 = fixed._cache_key(("dense", 8, 16), 2, torch.float64, False)
    k2 = adaptive._cache_key(("dense", 8, 16), 2, torch.float64, False)
    assert k1 != k2 and k1[2] == "float64"
    assert k1[5] == (opts.ruiz_iters, opts.lanczos_iters,
                     opts.norm_override, opts.norm_backend)


def test_batch_instances_get_distinct_streams():
    lp = random_standard_lp(8, 14, seed=4)
    opts = PDHGOptions(max_iters=128, tol=1e-30, check_every=64)
    r = BatchSolver(opts, sigma_read=0.01,
                    torch_device="cpu").solve_stream([lp, lp])
    assert not np.allclose(r[0].x, r[1].x)
    assert r[0].merit != r[1].merit
    # and the per-lane start comes from (seed, position)
    solver = BatchSolver(opts, torch_device="cpu")
    keys = solver._instance_keys([0, 1], 2, 4)
    assert len(set(keys)) == 4
    assert keys[:2] == BatchSolver(opts, torch_device="cpu")._instance_keys(
        [0, 1], 5, 2)


def test_batch_seed_and_sigma_read_reach_the_pipeline():
    lp = random_standard_lp(8, 14, seed=6)
    mk = lambda s: PDHGOptions(  # noqa: E731
        max_iters=128, tol=1e-30, check_every=64, seed=s)
    r0 = BatchSolver(mk(0), torch_device="cpu").solve_stream([lp])[0]
    r0b = BatchSolver(mk(0), torch_device="cpu").solve_stream([lp])[0]
    r1 = BatchSolver(mk(7), torch_device="cpu").solve_stream([lp])[0]
    np.testing.assert_array_equal(r0.x, r0b.x)
    assert not np.allclose(r0.x, r1.x)
    noisy = BatchSolver(mk(0), sigma_read=0.05,
                        torch_device="cpu").solve_stream([lp])[0]
    assert not np.allclose(r0.x, noisy.x)


def test_norm_reuse_seeds_repeat_instances():
    lps = [random_standard_lp(8, 14, seed=s) for s in (0, 1)]
    opts = PDHGOptions(max_iters=1500, tol=1e-4, check_every=64)
    solver = BatchSolver(opts, norm_reuse=True, torch_device="cpu")
    r1 = solver.solve_stream(lps)
    assert solver.last_stream_stats["norm_seeded_buckets"] == 0
    # the seeded twin was built on the cold pass: the warm pass builds
    # nothing
    r2 = solver.solve_stream(lps)
    assert solver.last_stream_stats["norm_seeded_buckets"] == 1
    assert solver.last_stream_stats["compiles"] == 0
    for a, b in zip(r1, r2):
        assert b.status == a.status
        np.testing.assert_allclose(b.obj, a.obj, rtol=1e-4, atol=1e-6)
        if a.iterations == b.iterations:
            assert a.mvm_calls - b.mvm_calls == \
                opts.lanczos_iters - tb.NORM_REFINE_ITERS


def test_norm_cache_isolated_by_fingerprint(x64_module):
    from repro_torch.lp import sparse_random_standard_lp

    rb = _ref_batch()
    _, rpdhg = reference()
    solver = BatchSolver(PDHGOptions(max_iters=256, tol=1e-30,
                                     check_every=64), norm_reuse=True,
                         torch_device="cpu")
    a = sparse_random_standard_lp(10, 18, density=0.3, seed=0)
    b = sparse_random_standard_lp(10, 18, density=0.3, seed=3)
    solver.solve_stream([a, b])
    fps = {solver._norm_fingerprint(lp) for lp in (a, b)}
    assert len(fps) == 2
    assert set(solver._norm_cache) == fps
    # the same blake2b key as the reference, on the same instances
    from repro.lp import sparse_random_standard_lp as ref_sparse

    ref = rb.BatchSolver(rpdhg.PDHGOptions())
    assert fps == {ref._norm_fingerprint(ref_sparse(10, 18, density=0.3,
                                                    seed=s))
                   for s in (0, 3)}
    cold = BatchSolver(PDHGOptions(max_iters=128, tol=1e-30),
                       torch_device="cpu")
    cold.solve_stream([random_standard_lp(8, 14, seed=0)])
    assert cold._norm_cache == {}


def test_padded_batch_and_filler_lanes():
    solver = BatchSolver(PDHGOptions(), torch_device="cpu")
    assert [solver._padded_batch(k) for k in (1, 2, 3, 5, 8)] == \
        [1, 2, 4, 8, 8]


def test_transfer_sanitizer_runs_the_stream_on_cpu():
    # without a card there is nothing to synchronise with: the guard is a
    # no-op and the served numbers are unchanged
    opts = PDHGOptions(max_iters=256, tol=1e-30, check_every=64)
    lps = _stream()[:2]
    a = BatchSolver(opts, torch_device="cpu").solve_stream(lps)
    b = BatchSolver(opts, transfer_sanitize=True,
                    torch_device="cpu").solve_stream(lps)
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p.x, q.x)
    with sanitize.no_implicit_transfers():
        assert sanitize.host_read(torch.ones((), dtype=torch.bool))


def test_batch_solver_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchSolver(PDHGOptions())


def test_f32_stream_pads_and_solves_in_f32():
    rng = np.random.default_rng(0)
    lp32 = StandardLP(
        c=rng.normal(size=14).astype(np.float32),
        K=rng.normal(size=(8, 14)).astype(np.float32),
        b=rng.normal(size=8).astype(np.float32),
        lb=np.zeros(14, np.float32), ub=np.full(14, np.inf, np.float32))
    padded = tb.pad_problem(lp32, 16, 32)
    assert all(getattr(padded, f).dtype == np.float32
               for f in ("K", "b", "c", "lb", "ub"))
    r = BatchSolver(PDHGOptions(max_iters=128, dtype=torch.float32),
                    torch_device="cpu").solve_stream([lp32])[0]
    assert r.x.dtype == np.float32


# ------------------------------------------------ batched norm estimate ---

def test_tridiag_radius_matches_eigvalsh():
    g = torch.Generator().manual_seed(0)
    for k in (1, 2, 7, 64):
        a = torch.randn(5, k, generator=g, dtype=torch.float64)
        b = torch.randn(5, k - 1, generator=g, dtype=torch.float64)
        a[0] = 0.0                              # +-sigma pairs
        got = tridiag_radius(a, b)
        for i in range(5):
            T = torch.diag(a[i]) + torch.diag(b[i], 1) + torch.diag(b[i], -1)
            want = torch.linalg.eigvalsh(T).abs().max()
            torch.testing.assert_close(got[i], want, rtol=1e-13, atol=0)
    zero = torch.zeros(2, 3, dtype=torch.float64)
    assert torch.equal(tridiag_radius(zero, zero[:, :2]),
                       torch.zeros(2, dtype=torch.float64))


@pytest.mark.parametrize("norm", ["lanczos", "power"])
def test_batched_norm_estimates_match_single(norm):
    g = torch.Generator().manual_seed(1)
    Ms = []
    for _ in range(3):
        K = torch.randn(6, 11, generator=g, dtype=torch.float64)
        M = torch.zeros(17, 17, dtype=torch.float64)
        M[:6, 6:], M[6:, :6] = K, K.T
        Ms.append(M)
    Mb = torch.stack(Ms)
    v0 = torch.randn(17, generator=g, dtype=torch.float64)
    est = lanczos_svd_jit_mv if norm == "lanczos" else power_iteration_mv
    kw = {"k_max": 12} if norm == "lanczos" else {"iters": 12}
    batched = est(engine.matvec(Mb), 17, torch.float64, v0=v0, batch=3,
                  **kw)
    for i, M in enumerate(Ms):
        single = est(engine.matvec(M), 17, torch.float64, v0=v0, **kw)
        torch.testing.assert_close(batched[i], single, rtol=1e-13, atol=0)


# -------------------------------------------------------------- the CLI ---

def _cli(*args):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.solve", "--torch-device",
         "cpu", "--backend", "batch", *args],
        capture_output=True, text=True, env=env, timeout=300, cwd=root)


def test_cli_batch_serves_a_dense_stream_on_cpu():
    out = _cli("--instances", "rand:8x14,rand:10x18", "--max-iters", "4000")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert sum("status=optimal" in ln for ln in lines) == 2
    assert "bucket=(8, 16)" in out.stdout and "bucket=(16, 32)" in out.stdout
    assert lines[-1].startswith("stream: buckets=2 ")
    assert "host_stack_bytes=dense:" in lines[-1]
    assert lines[-1].endswith("/sparse:0")


def test_cli_batch_sparse_stream_never_densifies():
    out = _cli("--sparse", "--instances", "sprand:24x48:0.2,sprand:20x40:0.2",
               "--tol", "1e-4", "--megakernel", "--sync")
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("sparse(nnz=") == 2
    assert out.stdout.count("status=optimal") == 2
    assert "host_stack_bytes=dense:0/sparse:" in out.stdout


# ------------------------------------------------------------ on a card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the transfer guard has nothing to "
                    "watch without one")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sparse_kernel", [None, "ell", "bcoo"])
def test_transfer_sanitizer_allows_only_the_sanctioned_reads_on_card(
        cuda, sparse_kernel):
    """Under the guard a stream runs its stacking upload and one host read
    a window and nothing else that waits for the host; the answers are
    those of an unguarded run."""
    from repro_torch.lp import sparse_lp_stream

    opts = PDHGOptions(max_iters=512, tol=1e-6, check_every=64,
                       lanczos_iters=16)
    if sparse_kernel is None:
        lps = _stream()
    else:
        lps = sparse_lp_stream(3, [(20, 40), (24, 48)], density=0.15,
                               seed=2)
        opts = dataclasses.replace(opts, sparse_kernel=sparse_kernel,
                                   megakernel=sparse_kernel == "ell")
    guarded = BatchSolver(opts, transfer_sanitize=True).solve_stream(lps)
    plain = BatchSolver(opts, async_dispatch=False).solve_stream(lps)
    for g, p in zip(guarded, plain):
        assert g.iterations == p.iterations
        np.testing.assert_allclose(g.x, p.x, rtol=0, atol=1e-12)
    with pytest.raises(RuntimeError):
        with sanitize.no_implicit_transfers():
            torch.ones(3, device=cuda).sum().item()
