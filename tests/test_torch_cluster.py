"""Multi-host serving of the port (``repro_torch.runtime.cluster``):
routing and env detection held against the reference, the transport's
torn writes, virtual-pod reroutes in one process, two pod processes
whose routed stream is bitwise one process's (also with a worker killed
mid-stream), and the CLI's ``--backend distributed`` and ``--cluster``
flags, in one process and as two gloo ranks on the CPU."""
import json
import os
import sys
import time

import numpy as np
import pytest
from _torch_dist_harness import (
    free_port,
    harness_stream,
    harness_stream_opts,
    run_ranks,
    spawn,
    stream_arrays,
    wait_all,
)
from _torch_parity import one_torch_thread  # noqa: F401  (autouse)

from repro_torch.core.pdhg import PDHGOptions
from repro_torch.lp import random_standard_lp
from repro_torch.runtime import BatchSolver, ClusterBatchSolver
from repro_torch.runtime import cluster as cluster_mod
from repro_torch.runtime.cluster import (
    DirectoryTransport,
    StragglerTimeout,
    bucket_cost,
    bucket_tag,
    route_buckets,
)

OPTS = PDHGOptions(max_iters=2000, tol=1e-4, check_every=64,
                   lanczos_iters=16)
HARNESS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_torch_dist_harness.py")
ENV_NAMES = ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID",
             "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
             "JAX_PROCESS_ID")


def _stream():
    return [random_standard_lp(8, 14, seed=0),
            random_standard_lp(10, 18, seed=1),
            random_standard_lp(20, 34, seed=2),
            random_standard_lp(7, 13, seed=3)]


def _same(a, b):
    for u, v in zip(a, b):
        assert np.array_equal(u.x, v.x) and np.array_equal(u.y, v.y)
        assert u.merit == v.merit and u.iterations == v.iterations


# ------------------------------------------------------------- routing ---

def test_routing_matches_reference():
    """``bucket_tag``, ``bucket_cost`` and the LPT table equal the
    reference's on the same buckets, for 1 to 5 pods."""
    from repro.runtime import cluster as ref

    rng = np.random.default_rng(0)
    keys = ([((8 << i, 16 << i), None) for i in range(5)]
            + [((128, 256), 512), ((128, 256), ("ell", 8, 4)),
               ((64, 128), ("ell", 4, 4))])
    costs = {k: bucket_cost(k, int(rng.integers(1, 9))) for k in keys}
    assert {bucket_tag(k) for k in keys} == {ref.bucket_tag(k) for k in keys}
    for k in keys:
        assert bucket_cost(k, 4) == ref.bucket_cost(k, 4)
    for pods in range(1, 6):
        assert route_buckets(costs, pods) == ref.route_buckets(costs, pods)
    assert route_buckets(costs, 3) == route_buckets(dict(
        reversed(list(costs.items()))), 3)


@pytest.mark.parametrize("env", [
    {},
    {"REPRO_COORDINATOR": "h:1", "REPRO_NUM_PROCESSES": "2"},
    {"REPRO_COORDINATOR": "h:1", "REPRO_NUM_PROCESSES": "2",
     "REPRO_PROCESS_ID": "1"},
    {"JAX_COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "4",
     "JAX_PROCESS_ID": "3"},
    {"REPRO_COORDINATOR": "h:1", "REPRO_NUM_PROCESSES": "1",
     "REPRO_PROCESS_ID": "0"},
    {"REPRO_COORDINATOR": "h:1", "REPRO_NUM_PROCESSES": "two",
     "REPRO_PROCESS_ID": "0"},
], ids=["none", "partial", "full", "jax-names", "one", "malformed"])
def test_detect_env_matches_reference(monkeypatch, env):
    from repro.runtime import cluster as ref

    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert cluster_mod.detect_env() == ref.detect_env()


def test_init_cluster_single_process_fallback(monkeypatch):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    cluster_mod._reset_for_tests()
    try:
        info = cluster_mod.init_cluster("auto", device="cpu")
        assert (info.num_processes, info.process_id, info.initialized) == \
            (1, 0, False)
        assert cluster_mod.pod_count() == 1 and cluster_mod.pod_id() == 0
        cluster_mod._reset_for_tests()
        monkeypatch.setenv("REPRO_COORDINATOR", "h:1")
        monkeypatch.setenv("REPRO_NUM_PROCESSES", "2")
        monkeypatch.setenv("REPRO_PROCESS_ID", "0")
        # "off" never initializes, whatever the env says
        assert not cluster_mod.init_cluster("off").is_multiprocess
        cluster_mod._reset_for_tests()
        with pytest.raises(ValueError):
            cluster_mod.init_cluster("on")
    finally:
        cluster_mod._reset_for_tests()


# ----------------------------------------------------------- transport ---

def test_transport_publish_fetch_and_torn_writes(tmp_path):
    tr = DirectoryTransport(str(tmp_path))
    key = ((16, 32), None)
    tr.publish_manifest(0, {key: 1, ((8, 16), None): 0}, {"n_pods": 2})
    assert tr.fetch_manifest(0).meta["routing"] == {"16x32-dense": 1,
                                                    "8x16-dense": 0}
    assert set(tr.pending_from_manifest(0, [0, 1])) == {"16x32-dense",
                                                        "8x16-dense"}
    # a crash mid-publish leaves a *.tmp that no reader opens, and a
    # half-written bucket file under the final name reads as absent
    sd = tr._stream_dir(0)
    with open(os.path.join(sd, "bucket_16x32-dense.npz.tmp"), "wb") as f:
        f.write(b"\x00garbage torn write")
    assert tr.try_fetch_bucket(0, "16x32-dense") is None
    with open(os.path.join(sd, "bucket_8x16-dense.npz"), "wb") as f:
        f.write(b"PK\x03\x04 torn")
    assert tr.try_fetch_bucket(0, "8x16-dense") is None
    tr.publish_bucket(0, bucket_tag(key), 1, {"xs": np.ones((2, 3))},
                      {"idxs": [0, 1]})
    got = tr.try_fetch_bucket(0, bucket_tag(key))
    np.testing.assert_array_equal(got.arrays["xs"], np.ones((2, 3)))
    assert got.meta["idxs"] == [0, 1] and got.meta["pod"] == 1
    assert tr.pending_from_manifest(0, [1]) == []
    assert tr.try_fetch_bucket(1, bucket_tag(key)) is None


# ------------------------------------------- single-process cluster ---

def test_single_pod_and_virtual_pods_are_the_base_solver(tmp_path):
    """One pod is the base solver; with a virtual pod (no live process)
    the coordinator reroutes its buckets and the results are bitwise the
    base solver's, warm across two streams."""
    lps = _stream()
    base = BatchSolver(OPTS, torch_device="cpu").solve_stream(lps)
    _same(base, ClusterBatchSolver(OPTS, n_pods=1, torch_device="cpu")
          .solve_stream(lps))
    solver = ClusterBatchSolver(
        OPTS, pod=0, n_pods=2, live_pods=1, torch_device="cpu",
        transport=DirectoryTransport(str(tmp_path)), straggler_timeout=30.0)
    _same(base, solver.solve_stream(lps))
    st = solver.last_stream_stats
    assert st["rerouted_buckets"] > 0
    assert st["n_local_buckets"] < st["n_buckets"]
    assert set(st["routing"].values()) == {0, 1}
    assert solver.transport.pending_from_manifest(0, [0, 1]) == []
    misses = solver.cache_misses
    _same(base, solver.solve_stream(lps))
    assert solver.cache_misses == misses and solver.stream_seq == 2


def test_gather_timeout_raises(tmp_path):
    solver = ClusterBatchSolver(
        OPTS, pod=1, n_pods=2, live_pods=2, torch_device="cpu",
        transport=DirectoryTransport(str(tmp_path)),
        straggler_timeout=0.2, gather_timeout=1.0)
    with pytest.raises(StragglerTimeout):
        solver.solve_stream(_stream())


# ------------------------------------------------- two pod processes ---

@pytest.fixture(scope="module")
def one_process():
    """The bitwise ground truth: the harness stream through one
    ``BatchSolver`` in this process (one torch thread, as the pods)."""
    solver = BatchSolver(harness_stream_opts(), torch_device="cpu")
    return stream_arrays(solver.solve_stream(harness_stream()))


def test_two_pods_routed_stream_bitwise(one_process, tmp_path):
    """Two pod processes over a ``DirectoryTransport``: each serves its
    routed buckets, the coordinator gathers the rest; the stream is
    bitwise one process's."""
    out = run_ranks(2, "pod", {}, str(tmp_path), timeout=240, pg=False)[0]
    routing = json.loads(str(out["routing"]))
    assert set(routing.values()) == {0, 1} and int(out["rerouted"]) == 0
    for k, v in one_process.items():
        assert np.array_equal(out[k], v), k


def test_killed_worker_buckets_are_rerouted(one_process, tmp_path):
    """Pod 1 hangs before publishing any bucket and is killed: after the
    straggler timeout the coordinator serves its buckets, read back from
    the manifest, and the stream is still bitwise one process's."""
    d = str(tmp_path)
    with open(os.path.join(d, "args.json"), "w") as f:
        json.dump({"stall": {"1": 0}, "straggler_timeout": 3.0,
                   "gather_timeout": 120.0}, f)
    procs = [spawn([sys.executable, HARNESS, "--scenario", "pod",
                    "--rank", str(r), "--world", "2", "--port", "0",
                    "--dir", d, "--no-pg"]) for r in range(2)]
    try:
        deadline = time.monotonic() + 120
        while procs[0].poll() is None and time.monotonic() < deadline:
            if procs[1].poll() is None and os.path.exists(os.path.join(
                    d, "transport", "stream00000", "manifest.npz")):
                procs[1].kill()          # the worker dies mid-stream
            time.sleep(0.2)
    finally:
        procs[1].kill()
    wait_all(procs, 60, allow_fail=(1,))
    out = np.load(os.path.join(d, "rank0.npz"))
    assert int(out["rerouted"]) >= 1
    for k, v in one_process.items():
        assert np.array_equal(out[k], v), k


# ------------------------------------------------------------------ CLI ---

def test_cli_distributed_and_pods_in_one_process(capsys):
    from repro_torch.core.pdhg import solve_jit
    from repro_torch.launch import solve as cli

    cluster_mod._reset_for_tests()
    try:
        res = cli.main(["--torch-device", "cpu", "--backend", "distributed",
                        "--instance", "rand:24x40"])
        ref = solve_jit(cli.load_instance("rand:24x40"),
                        PDHGOptions(max_iters=40000, check_every=100),
                        device="cpu")
        assert res.status == "optimal" and res.iterations == ref.iterations
        np.testing.assert_allclose(res.x, ref.x, rtol=0, atol=1e-10)
        out = cli.main(["--torch-device", "cpu", "--backend", "batch",
                        "--pods", "2", "--instances",
                        "rand:8x14,rand:10x18,rand:24x40"])
        assert all(r.status == "optimal" for r in out)
        assert "cluster: pod=0/2" in capsys.readouterr().out
        for bad in (["--backend", "distributed", "--megakernel"],
                    ["--pods", "2"],
                    ["--backend", "batch", "--device", "taox", "--cluster",
                     "auto"]):
            with pytest.raises(SystemExit):
                cli.main(["--torch-device", "cpu", *bad])
    finally:
        cluster_mod._reset_for_tests()


def test_cli_cluster_auto_two_processes(tmp_path):
    """``--cluster auto`` with the REPRO_* env in two processes: the
    distributed backend over a process group of two gloo ranks (the
    cluster mesh, pod axis 2), and a batch stream routed over two pods
    through REPRO_TRANSPORT_DIR, each as one process would solve it."""
    port = free_port()

    def run(args, extra=None):
        procs = [spawn([sys.executable, "-m", "repro_torch.launch.solve",
                        "--torch-device", "cpu", "--cluster", "auto",
                        *args],
                       {"REPRO_COORDINATOR": f"localhost:{port}",
                        "REPRO_NUM_PROCESSES": "2",
                        "REPRO_PROCESS_ID": str(r), **(extra or {})})
                 for r in range(2)]
        return wait_all(procs, 240)

    outs = run(["--backend", "distributed", "--instance", "rand:24x40"])
    for o in outs:
        assert "status=optimal iters=1500" in o, o
    port = free_port()
    outs = run(["--backend", "batch", "--instances",
                "rand:8x14,rand:10x18,rand:24x40"],
               {"REPRO_TRANSPORT_DIR": str(tmp_path)})
    lines = [[ln for ln in o.splitlines() if ln.startswith("instance=")]
             for o in outs]
    assert len(lines[0]) == 3 and lines[0] == lines[1]
    assert "cluster: pod=0/2" in outs[0] and "cluster: pod=1/2" in outs[1]
