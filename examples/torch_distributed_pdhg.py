"""Distributed PDHG (the PyTorch port): one LP sharded across a mesh of
ranks (crossbar-style), plus the batched solver-as-a-service mode.

    PYTHONPATH=src python examples/torch_distributed_pdhg.py           # the card
    PYTHONPATH=src python examples/torch_distributed_pdhg.py --device cpu

Each rank is a process of this script over ``torch.distributed``: the
example starts ``world`` of them (8 by default), each joining a process
group at a free localhost port, and prints rank 0's lines.  On the CPU
the group runs over gloo; on the card too when the ranks outnumber the
cards (NCCL refuses two ranks on one card), else over NCCL.  In a
cluster the same code runs one rank a card (``runtime.cluster``).
"""
import argparse
import json
import os
import socket
import subprocess
import sys

HERE = os.path.abspath(__file__)
SRC = os.path.join(os.path.dirname(os.path.dirname(HERE)), "src")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_main(rank: int, world: int, port: int, cfg: dict) -> None:
    """One rank: the sharded solves on 2-D and 3-D meshes, then a
    batch of independent LPs split over the ranks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import PDHGOptions
    from repro_torch.distributed import solve_batch, stack_problems
    from repro_torch.distributed.pdhg_dist import solve_dist
    from repro_torch.lp import random_standard_lp
    from repro_torch.runtime.mesh import make_mesh

    device = cfg["device"]
    torch.set_num_threads(1)
    if device.startswith("cuda"):
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(cfg["backend"],
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        say(f"ranks: {world} ({cfg['backend']} on {device})")
        opts = PDHGOptions(max_iters=cfg["max_iters"], tol=1e-6,
                           check_every=100)

        # --- one large LP, 2-D sharded like the paper's crossbar grid ---
        mesh = make_mesh((2, world // 2), ("data", "model"), device=device)
        lp = random_standard_lp(cfg["m"], cfg["n"], seed=0)
        r = solve_dist(lp, mesh, opts)
        say(f"sharded solve  : mesh 2x{world // 2} obj={r.obj:.6f} "
            f"rel_err={abs(r.obj - lp.obj_opt) / abs(lp.obj_opt):.2e} "
            f"iters={r.iterations}")

        # --- multi-pod mesh: the 'pod' axis joins the row-block sharding
        mesh3 = make_mesh((2, 2, world // 4), ("pod", "data", "model"),
                          device=device)
        r3 = solve_dist(lp, mesh3, opts)
        say(f"multi-pod solve: mesh 2x2x{world // 4} obj={r3.obj:.6f} "
            f"rel_err={abs(r3.obj - lp.obj_opt) / abs(lp.obj_opt):.2e}")

        # --- batched mode: independent LPs split over the ranks ---------
        flat = make_mesh((world,), ("data",), device=device)
        bm, bn = cfg["batch_shape"]
        lps = [random_standard_lp(bm, bn, seed=s) for s in range(world)]
        Ks, bs, cs, lbs, ubs = stack_problems(lps)
        out = solve_batch(Ks, bs, cs, lbs, ubs, flat, opts)
        objs = np.einsum("bn,bn->b", cs, out["x"])
        errs = [abs(o - p.obj_opt) / abs(p.obj_opt)
                for o, p in zip(objs, lps)]
        say(f"batched solve  : {world} LPs, max rel_err={max(errs):.2e}, "
            f"converged={int(np.sum(out['converged']))}/{world}")
    finally:
        dist.destroy_process_group()


def main(world: int = 8, m: int = 128, n: int = 256,
         batch_shape=(24, 40), max_iters: int = 30000, device=None,
         timeout: float = 900.0) -> str:
    """Start ``world`` ranks (a multiple of 4) of this script, wait for
    all of them within ``timeout`` seconds, print and return rank 0's
    output.  Any rank that fails fails the run, after every rank has
    been stopped."""
    import torch

    from repro_torch._device import resolve_device

    if world % 4:
        raise ValueError(f"world must be a multiple of 4, got {world}")
    dev = resolve_device(device)
    backend = "nccl" if (dev.type == "cuda"
                         and world <= torch.cuda.device_count()) else "gloo"
    cfg = {"device": str(dev), "backend": backend, "m": m, "n": n,
           "batch_shape": list(batch_shape), "max_iters": max_iters}
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    procs = [subprocess.Popen(
        [sys.executable, HERE, "--rank", str(r), "--world", str(world),
         "--port", str(port), "--cfg", json.dumps(cfg)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = [None] * world
    try:
        for i, p in enumerate(procs):
            outs[i] = p.communicate(timeout=timeout)[0]
            if p.returncode != 0:
                raise RuntimeError(f"rank {i} exited {p.returncode}:\n"
                                   f"{outs[i]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    print(outs[0], end="")
    return outs[0]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--world", type=int, default=8)
    # one rank (the example starts these itself)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--cfg", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.rank is None:
        main(world=a.world, device=a.device)
    else:
        rank_main(a.rank, a.world, a.port, json.loads(a.cfg))
