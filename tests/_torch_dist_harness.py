"""Spawn ranks of the port's distributed path on the CPU (gloo over
localhost) for the ``test_torch_*`` tests.

``run_ranks(world, scenario, args, directory)`` starts ``world``
processes of this file, each its own rank of a gloo process group at a
free localhost port (``torch.distributed.init_process_group`` with a
``tcp://`` rendezvous), runs ``SCENARIOS[scenario](rank, args, dir)``
and waits for all of them within a timeout.  A rank that fails or
outlives the timeout fails the call, after every rank has been killed.
Each rank writes what the test compares to ``dir/rank<r>.npz`` (numpy
only: the ranks import the port, never JAX).  A scenario with
``pg=False`` gets no process group (the cluster pods, which meet only
through their transport directory).

Process entry:

    python tests/_torch_dist_harness.py --scenario solve --rank 0 \\
        --world 4 --port 29500 --dir /tmp/run
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_env(extra=None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    # one thread a rank: the tensors are tiny and the ranks share cores
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra or {})
    return env


def spawn(cmd, env=None) -> subprocess.Popen:
    return subprocess.Popen(cmd, env=rank_env(env), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def wait_all(procs, timeout: float, allow_fail=()):
    """Wait for every process; return their outputs.  On a failure (a
    nonzero exit of one not in ``allow_fail``) or the timeout, kill them
    all and raise ``AssertionError`` with every output."""
    deadline = time.monotonic() + timeout
    outs = [None] * len(procs)
    try:
        for i, p in enumerate(procs):
            left = max(0.1, deadline - time.monotonic())
            outs[i] = p.communicate(timeout=left)[0]
            if p.returncode != 0 and i not in allow_fail:
                raise AssertionError(f"process {i} exited {p.returncode}")
    except (AssertionError, subprocess.TimeoutExpired) as err:
        for p in procs:
            p.kill()
        for i, p in enumerate(procs):
            if outs[i] is None:
                outs[i] = p.communicate()[0]
        raise AssertionError(
            f"{err}\n" + "\n".join(f"--- process {i} ---\n{o}"
                                   for i, o in enumerate(outs))) from None
    return outs


def run_ranks(world: int, scenario: str, args: dict, directory: str,
              timeout: float = 300.0, pg: bool = True):
    """Run ``scenario`` on ``world`` ranks; the per-rank npz results."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "args.json"), "w") as f:
        json.dump(args, f)
    port = free_port()
    procs = [spawn([sys.executable, os.path.abspath(__file__),
                    "--scenario", scenario, "--rank", str(r),
                    "--world", str(world), "--port", str(port),
                    "--dir", directory] + ([] if pg else ["--no-pg"]))
             for r in range(world)]
    wait_all(procs, timeout)
    out = []
    for r in range(world):
        path = os.path.join(directory, f"rank{r}.npz")
        out.append(dict(np.load(path)) if os.path.exists(path) else None)
    return out


# ----------------------------------------------------------- scenarios ---

def _opts(spec: dict):
    from repro_torch.core.pdhg import PDHGOptions

    return PDHGOptions(**spec)


def _lp(spec):
    from repro_torch.lp import random_standard_lp

    m, n, seed = spec
    return random_standard_lp(m, n, seed=seed)


def _draws(directory, name):
    from repro_torch.interop import Draws

    path = os.path.join(directory, f"{name}.npz")
    if not os.path.exists(path):
        return None
    z = np.load(path)
    return Draws(z["x0"], z["y0"], z["v0"])


def scenario_solve(rank, args, directory):
    """``solve_dist`` for each case of ``args["cases"]``: a mesh
    (shape, axes), an instance, options, an optional tile type and the
    name of an injected-draws file.  Every rank saves its results (all
    must be equal); the collective count rides along."""
    import torch

    from repro_torch.core import engine
    from repro_torch.distributed import solve_dist
    from repro_torch.runtime.mesh import make_mesh

    out = {}
    for case in args["cases"]:
        name = case["name"]
        mesh = make_mesh(tuple(case["shape"]), tuple(case["axes"]),
                         device="cpu")
        tile = getattr(torch, case["tile"]) if case.get("tile") else None
        engine.COLLECTIVES["all_reduce"] = 0
        res = solve_dist(_lp(case["lp"]), mesh, _opts(case["opts"]),
                         tile_dtype=tile,
                         draws=_draws(directory, case.get("draws", "")))
        out.update({f"{name}/x": res.x, f"{name}/y": res.y,
                    f"{name}/iterations": res.iterations,
                    f"{name}/merit": res.merit,
                    f"{name}/status": res.status,
                    f"{name}/sigma_max": res.sigma_max,
                    f"{name}/all_reduce": engine.COLLECTIVES["all_reduce"]})
    np.savez(os.path.join(directory, f"rank{rank}.npz"), **out)


def scenario_collectives(rank, args, directory):
    """``compressed_psum`` against the exact all-reduce over the "data"
    axis, and ``solve_batch`` on the mesh."""
    import torch

    from repro_torch.core.engine import all_reduce
    from repro_torch.distributed import compressed_psum, solve_batch
    from repro_torch.runtime.batch import stack_problems
    from repro_torch.runtime.mesh import make_mesh

    mesh = make_mesh({"data": args["world"]}, device="cpu")
    g = mesh.group("data")
    x = torch.as_tensor(np.random.default_rng(rank).normal(
        scale=3.0, size=256), dtype=torch.float32)
    out = {"x": x.numpy(), "exact": all_reduce(x.clone(), g).numpy()}
    for bits in (4, 8, 16):
        out[f"q{bits}"] = compressed_psum(x, g, bits=bits).numpy()
    gen = torch.Generator().manual_seed(100 + rank)
    out["stochastic"] = np.stack([compressed_psum(x, g, gen, bits=6).numpy()
                                  for _ in range(64)])
    lps = [_lp(spec) for spec in args["batch"]]
    stacked = stack_problems(lps)
    res = solve_batch(*stacked, mesh, _opts(args["opts"]))
    out.update({f"batch/{k}": v for k, v in res.items()})
    for name, results in mesh_streams(mesh).items():
        out.update({f"{name}/{k}": v
                    for k, v in stream_arrays(results).items()})
    np.savez(os.path.join(directory, f"rank{rank}.npz"), **out)


def mesh_streams(mesh=None) -> dict:
    """A small dense stream through ``BatchSolver`` and a noiseless
    TaOx-HfOx ``CrossbarBatchSolver``, each bucket's lanes split over
    ``mesh``'s "data" ranks (one process without a mesh)."""
    import dataclasses

    from repro_torch.crossbar import TAOX_HFOX, CrossbarBatchSolver
    from repro_torch.runtime import BatchSolver

    lps = [_lp(spec) for spec in ([8, 14, 0], [10, 18, 1], [8, 14, 2],
                                  [20, 34, 3], [7, 13, 4])]
    opts = harness_stream_opts()
    dev = dataclasses.replace(TAOX_HFOX, sigma_program=0.0, sigma_read=0.0)
    return {
        "stream": BatchSolver(opts, mesh=mesh, torch_device="cpu")
        .solve_stream(lps),
        "crossbar": CrossbarBatchSolver(
            dataclasses.replace(opts, max_iters=640), device=dev,
            mesh=mesh, torch_device="cpu").solve_stream(lps[:3]),
    }


def scenario_elastic(rank, args, directory):
    """``make_dist_step`` on a mesh: from the start (or the checkpoint
    ``args["restore"]``, placed by ``reshard``) run ``args["steps"]``
    steps, checkpointing the gathered state after ``args["save_at"]``
    of them; rank 0 saves the gathered final state."""
    import torch

    from repro_torch.core import pdhg as pdhg_mod
    from repro_torch.distributed import (
        load_checkpoint,
        make_dist_step,
        reshard,
        save_checkpoint,
        shard_problem,
    )
    from repro_torch.distributed.pdhg_dist import _start
    from repro_torch.distributed.sharding import (
        col_axes,
        gather_blocks,
        row_axes,
    )
    from repro_torch.runtime.mesh import make_mesh

    mesh = make_mesh(tuple(args["shape"]), ("data", "model"), device="cpu")
    opts = _opts(args["opts"])
    scaled, T, Sigma = pdhg_mod.prepare(_lp(args["lp"]), opts, "cpu")
    prob = shard_problem(scaled, T, Sigma, mesh)
    step = make_dist_step(mesh, n_inner=1)
    Rax, Cax = row_axes(mesh), col_axes(mesh)
    if args.get("restore"):
        ck = load_checkpoint(os.path.join(directory, args["restore"]))
        placed = reshard(ck.arrays, mesh,
                         {"x": (Cax,), "x_bar": (Cax,), "y": (Rax,)})
        state = tuple(placed[k] for k in ("x", "x_bar", "y", "tau",
                                          "sigma"))
    else:
        x0, y0 = _start(prob, opts, None)
        tau = torch.tensor(0.1, dtype=torch.float64)
        state = (x0, x0, y0, tau, tau)

    def full(state):
        x, x_bar, y, tau, sigma = state
        return {"x": gather_blocks(x, mesh, Cax),
                "x_bar": gather_blocks(x_bar, mesh, Cax),
                "y": gather_blocks(y, mesh, Rax), "tau": tau,
                "sigma": sigma}

    for k in range(1, args["steps"] + 1):
        state = step(prob.K, prob.b, prob.c, prob.lb, prob.ub, prob.T,
                     prob.Sigma, *state)
        if k == args.get("save_at"):
            arrays = full(state)
            if rank == 0:
                save_checkpoint(os.path.join(directory, "mid.npz"), k,
                                arrays, {"mesh": list(args["shape"])})
    arrays = {k: v.numpy() for k, v in full(state).items()}
    np.savez(os.path.join(directory, f"rank{rank}.npz"), **arrays)


def harness_stream():
    """The cluster tests' stream: mixed dense shapes in several buckets
    and one sparse bucket, rebuilt identically by every pod."""
    from repro_torch.lp import random_standard_lp, sparse_random_standard_lp

    lps = []
    shapes = [(8, 14), (10, 18), (20, 34), (7, 13)]
    for i in range(8):
        if i % 4 == 3:
            lps.append(sparse_random_standard_lp(96, 192, density=0.05,
                                                 seed=i))
        else:
            m, n = shapes[i % len(shapes)]
            lps.append(random_standard_lp(m, n, seed=i))
    return lps


def harness_stream_opts():
    from repro_torch.core.pdhg import PDHGOptions

    return PDHGOptions(max_iters=2000, tol=1e-4, check_every=64,
                       lanczos_iters=16, seed=0)


def stream_arrays(results):
    """A stream's results (a crossbar stream's reports: their
    ``result``) as arrays to compare."""
    results = [getattr(r, "result", r) for r in results]
    return {
        "x_cat": np.concatenate([r.x for r in results]),
        "y_cat": np.concatenate([r.y for r in results]),
        "merits": np.asarray([r.merit for r in results]),
        "iterations": np.asarray([r.iterations for r in results]),
    }


def scenario_pod(rank, args, directory):
    """One pod of a routed stream over a ``DirectoryTransport`` in
    ``directory``; with ``args["stall"]`` = {pod: K} that pod hangs after
    publishing K buckets (the straggler a test kills).  The coordinator
    saves the gathered results and the routing."""
    from repro_torch.runtime.cluster import (
        ClusterBatchSolver,
        DirectoryTransport,
    )

    stall = args.get("stall", {}).get(str(rank))

    class Pod(ClusterBatchSolver):
        published = 0

        def _bucket_served(self, key, idxs, out):
            if stall is not None and self.published >= stall:
                print(f"POD{rank} STALLED after {self.published} buckets",
                      flush=True)
                time.sleep(3600)
            super()._bucket_served(key, idxs, out)
            self.published += 1

    solver = Pod(harness_stream_opts(), pod=rank, n_pods=args["world"],
                 live_pods=args["world"],
                 transport=DirectoryTransport(
                     os.path.join(directory, "transport")),
                 straggler_timeout=args.get("straggler_timeout", 30.0),
                 gather_timeout=args.get("gather_timeout", 120.0),
                 torch_device="cpu")
    results = solver.solve_stream(harness_stream())
    st = solver.last_stream_stats
    print(f"POD{rank} routing={st['routing']} rerouted="
          f"{st['rerouted_buckets']}", flush=True)
    if rank == 0:
        np.savez(os.path.join(directory, "rank0.npz"),
                 rerouted=st["rerouted_buckets"],
                 routing=json.dumps(st["routing"]),
                 **stream_arrays(results))


SCENARIOS = {"solve": scenario_solve, "collectives": scenario_collectives,
             "elastic": scenario_elastic, "pod": scenario_pod}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", required=True, choices=sorted(SCENARIOS))
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--no-pg", action="store_true")
    a = ap.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    with open(os.path.join(a.dir, "args.json")) as f:
        args = json.load(f)
    args["world"] = a.world
    if not a.no_pg:
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                                f"{a.port}", rank=a.rank,
                                world_size=a.world)
    try:
        SCENARIOS[a.scenario](a.rank, args, a.dir)
    finally:
        if not a.no_pg:
            dist.destroy_process_group()
    print(f"RANK{a.rank} DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
