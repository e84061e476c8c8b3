"""The port's LP solving CLI — the paper's workload on one card.

  PYTHONPATH=src python -m repro_torch.launch.solve --instance gen-ip002
  PYTHONPATH=src python -m repro_torch.launch.solve --instance rand:64x128 \
      --megakernel                 # one CUDA launch per check window
  PYTHONPATH=src python -m repro_torch.launch.solve --backend taox
      # crossbar-simulated (device physics + energy ledger)
  PYTHONPATH=src python -m repro_torch.launch.solve --backend epiram \
      --refine-rounds 2            # digital refinement on the same cells
  PYTHONPATH=src python -m repro_torch.launch.solve --torch-device cpu \
      --kernel torch               # plain PyTorch on the CPU
  PYTHONPATH=src python -m repro_torch.launch.solve --backend batch \
      --instances rand:8x14,rand:10x18,rand:24x40   # bucketed stream
  PYTHONPATH=src python -m repro_torch.launch.solve --backend batch \
      --sparse --instances sprand:96x192:0.05,sprand:128x256:0.02
      # sparse ELL stream: B4 on every MVM (B5 with --megakernel)
  PYTHONPATH=src python -m repro_torch.launch.solve --backend batch \
      --device taox --instances rand:8x14,rand:10x18,rand:24x40
      # device-tile-aware stream through the crossbar simulator
  PYTHONPATH=src python -m repro_torch.launch.solve --instance \
      rand:96x160 --backend distributed   # sharded PDHG over the ranks
  REPRO_COORDINATOR=localhost:29500 REPRO_NUM_PROCESSES=4 \
  REPRO_PROCESS_ID=<0..3> PYTHONPATH=src python -m \
      repro_torch.launch.solve --backend distributed --cluster auto \
      --dist-backend gloo --instance rand:96x160
      # one process a rank, four ranks on one card over gloo
  REPRO_COORDINATOR=localhost:29500 REPRO_NUM_PROCESSES=2 \
  REPRO_PROCESS_ID=<0|1> REPRO_TRANSPORT_DIR=/shared/dir PYTHONPATH=src \
  python -m repro_torch.launch.solve --backend batch --cluster auto \
      --instances rand:8x14,rand:10x18,rand:24x40
      # multi-host serving: per-pod bucket routing + straggler reroute

``--backend exact`` runs the dense ``solve_jit``; ``epiram``/``taox``
run ``crossbar.solve_crossbar_jit`` on that device model; ``batch``
serves ``--instances`` through ``runtime.BatchSolver`` (or, with
``--device``, ``crossbar.solve_crossbar_stream``; with ``--pods`` or a
cluster, ``runtime.ClusterBatchSolver``); ``distributed`` runs
``distributed.solve_dist`` over the local mesh of the process group's
ranks (one rank without one), or ``solve_dist_auto`` with ``--cluster
auto``.  ``--device`` is the crossbar device model of the batch stream,
as in the reference; the hardware is chosen with ``--torch-device``.
``--trace PATH`` records the run's spans (``repro_torch.spans``) and
writes them, with the device's idle seconds by span on a card, to PATH.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json

import torch

from .. import spans
from ..core.engine import KERNELS, STEP_RULES
from ..core.lanczos import NORM_BACKENDS
from ..core.pdhg import PDHGOptions, solve_jit
from ..crossbar import (
    EPIRAM,
    TAOX_HFOX,
    solve_crossbar_jit,
    solve_crossbar_stream,
)
from ..lp import (
    TABLE1_SIZES,
    pagerank_lp,
    random_standard_lp,
    sparse_random_standard_lp,
    table1_instance,
)

CROSSBAR_BACKENDS = {"epiram": EPIRAM, "taox": TAOX_HFOX}


def load_instance(spec: str, seed: int = 0):
    if spec in TABLE1_SIZES:
        return table1_instance(spec, seed=seed)
    if spec.startswith("rand:"):
        m, n = spec[5:].split("x")
        return random_standard_lp(int(m), int(n), seed=seed)
    if spec.startswith("sprand:"):
        # sprand:MxN[:density] — COO-native sparse instance
        parts = spec[7:].split(":")
        m, n = parts[0].split("x")
        density = float(parts[1]) if len(parts) > 1 else 0.05
        return sparse_random_standard_lp(int(m), int(n), density=density,
                                         seed=seed)
    if spec.startswith("pagerank:"):
        return pagerank_lp(int(spec.split(":")[1]), seed=seed)
    raise ValueError(f"unknown instance {spec!r}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.solve")
    ap.add_argument("--instance", default="gen-ip002")
    ap.add_argument("--instances", default=None,
                    help="comma-separated specs for --backend batch")
    ap.add_argument("--backend", default="exact",
                    choices=["exact", *CROSSBAR_BACKENDS, "distributed",
                             "batch"])
    ap.add_argument("--device", default="none",
                    choices=["none", *CROSSBAR_BACKENDS],
                    help="with --backend batch: serve the stream through "
                         "the device-tile-aware crossbar simulator")
    ap.add_argument("--sparse", action="store_true",
                    help="with --backend batch: serve the stream through "
                         "the sparse pipeline (instances loaded as "
                         "sprand: specs are sparse already; dense specs "
                         "are converted).  Memory is proportional to "
                         "nonzeros — no dense (B, m, n) stack exists")
    ap.add_argument("--sync", action="store_true",
                    help="with --backend batch: serve one bucket at a "
                         "time instead of interleaving the buckets' "
                         "windows on their own CUDA streams")
    ap.add_argument("--norm-reuse", action="store_true",
                    help="with --backend batch: reuse operator-norm "
                         "estimates across stream passes, keyed by "
                         "(shape bucket, sparsity fingerprint)")
    ap.add_argument("--cluster", default="off", choices=["auto", "off"],
                    help="multi-host serving: 'auto' initializes the "
                         "process group from REPRO_COORDINATOR/"
                         "REPRO_NUM_PROCESSES/REPRO_PROCESS_ID (falling "
                         "back to single-process when unset) and routes "
                         "buckets across pods; 'off' serves everything "
                         "in-process")
    ap.add_argument("--pods", type=int, default=None,
                    help="route buckets across N pods (default: the "
                         "detected process count).  N beyond the live "
                         "process count creates virtual pods whose "
                         "buckets the coordinator reroutes")
    ap.add_argument("--dist-backend", default=None,
                    choices=["nccl", "gloo"],
                    help="torch.distributed backend of the cluster's "
                         "process group and the mesh's groups (default "
                         "nccl on the card, gloo on the CPU); several "
                         "ranks on one card need gloo, which NCCL "
                         "refuses")
    ap.add_argument("--kernel", default="cuda", choices=KERNELS,
                    help="update backend: the hand-written CUDA kernels "
                         "(their plain versions on CPU tensors) or plain "
                         "PyTorch; the counterparts of the reference's "
                         "pallas | jnp")
    ap.add_argument("--megakernel", action="store_true",
                    help="run each check window as one CUDA launch "
                         "(noiseless paths: --backend exact and batch)")
    ap.add_argument("--torch-device", default="cuda",
                    choices=["cuda", "cpu"],
                    help="hardware the solve runs on")
    ap.add_argument("--step-rule", default="fixed", choices=STEP_RULES)
    ap.add_argument("--gamma", type=float, default=0.0,
                    help="strong-convexity modulus for "
                         "--step-rule strongly_convex")
    ap.add_argument("--norm-backend", default="lanczos",
                    choices=NORM_BACKENDS)
    ap.add_argument("--refine-rounds", type=int, default=0,
                    help="crossbar backends only: digital iterative-"
                         "refinement rounds — each re-solves the "
                         "residual-correction LP on the SAME programmed "
                         "conductances (shifted b/c, zero extra write "
                         "cycles)")
    ap.add_argument("--refine-tol", type=float, default=0.0,
                    help="stop adopting refinement corrections once the "
                         "exact digital KKT merit reaches this "
                         "(default 0 = refine for all rounds)")
    ap.add_argument("--ecc", type=int, default=1,
                    help="crossbar backends only: k-fold differential-"
                         "pair replication with median decode, ledgered "
                         "separately under the *_ecc fields")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-iters", type=int, default=40000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the run's spans (repro_torch.spans) and, "
                         "on a card, trace it with a CUDA-only "
                         "torch.profiler; write the records, the counters "
                         "and the device's idle seconds by the span open "
                         "on the host to PATH as JSON")
    args = ap.parse_args(argv)
    crossbar_backend = (args.backend in CROSSBAR_BACKENDS
                        or (args.backend == "batch"
                            and args.device != "none"))
    # the reference's rules, word for word
    if (args.refine_rounds or args.refine_tol or args.ecc != 1) \
            and not crossbar_backend:
        ap.error("--refine-rounds/--refine-tol/--ecc only apply to the "
                 "crossbar backends (--backend epiram/taox or "
                 "--backend batch --device ...): refinement re-reads the "
                 "programmed array and ECC replicates its cells — exact "
                 "digital paths have neither")
    if args.ecc < 1:
        ap.error("--ecc must be >= 1 (1 = replication off)")
    if args.device != "none" and args.backend != "batch":
        ap.error("--device only applies to --backend batch "
                 "(use --backend epiram/taox for single instances)")
    if (args.sparse or args.sync) and args.backend != "batch":
        ap.error("--sparse/--sync only apply to --backend batch")
    if args.sparse and args.device != "none":
        ap.error("--sparse does not combine with --device: a crossbar "
                 "programs every physical cell, so device streams are "
                 "served densely")
    if args.norm_reuse and (args.backend != "batch"
                            or args.device != "none"):
        ap.error("--norm-reuse only applies to --backend batch without "
                 "--device (single solves estimate the norm once by "
                 "construction; the crossbar stream programs every cell "
                 "per instance, so there is nothing to reuse)")
    if args.megakernel and args.backend == "distributed":
        ap.error("--megakernel does not apply to --backend distributed "
                 "(the sharded loop steps: two all-reduces a step)")
    if args.pods is not None and args.backend != "batch":
        ap.error("--pods only applies to --backend batch (distributed "
                 "spans processes through the global mesh directly)")
    if (args.cluster != "off" or args.pods is not None) \
            and args.device != "none":
        ap.error("--cluster/--pods do not combine with --device: the "
                 "crossbar batch path is single-process")
    if args.trace is not None:
        return _traced(args.trace, args.torch_device,
                       lambda: _run(args, crossbar_backend))
    return _run(args, crossbar_backend)


def _run(args, crossbar_backend: bool):
    from ..runtime import cluster as cluster_mod

    info = cluster_mod.init_cluster(args.cluster, backend=args.dist_backend,
                                    device=args.torch_device)

    opts = PDHGOptions(max_iters=args.max_iters, tol=args.tol,
                       check_every=100, seed=args.seed,
                       kernel=args.kernel, megakernel=args.megakernel,
                       step_rule=args.step_rule, gamma=args.gamma,
                       norm_backend=args.norm_backend,
                       refine_rounds=args.refine_rounds,
                       refine_tol=args.refine_tol)
    if args.backend == "batch":
        results = _serve_stream(args, opts, info)
        cluster_mod.shutdown()      # leave a cluster's process group
        return results
    lp = load_instance(args.instance, seed=args.seed)
    led = None
    if args.backend == "distributed":
        res = _solve_distributed(args, lp, opts)
    elif crossbar_backend:
        dev = CROSSBAR_BACKENDS[args.backend]
        if args.ecc != 1:
            dev = dataclasses.replace(dev, ecc=args.ecc)
        rep = solve_crossbar_jit(lp, opts, device=dev,
                                 torch_device=args.torch_device)
        res, led = rep.result, rep.ledger
        if args.refine_rounds:
            print(f"refine: rounds={args.refine_rounds} "
                  f"executed_iters={rep.executed_iterations} "
                  f"digital_mvms={rep.digital_mvms} "
                  f"cells_written={led.cells_written} (all pre-refinement; "
                  f"rounds add READ windows only)")
        if dev.ecc > 1:
            print(f"ecc: k={dev.ecc} decode={dev.ecc_decode} "
                  f"write_ecc={led.write_energy_ecc_j:.4f}J "
                  f"cells_ecc={led.cells_written_ecc}")
    else:
        res = solve_jit(lp, opts, device=args.torch_device)

    print(f"instance={lp.name} shape={lp.K.shape} backend={args.backend}")
    print(f"status={res.status} iters={res.iterations} "
          f"sigma_max={res.sigma_max:.6f}")
    print(f"objective={res.obj:.6f}"
          + (f" (known optimum {lp.obj_opt:.6f}, "
             f"rel err {abs(res.obj-lp.obj_opt)/max(abs(lp.obj_opt),1e-12):.2e})"
             if lp.obj_opt is not None else ""))
    if led is not None:
        print(f"energy: write={led.write_energy_j:.4f}J "
              f"read={led.read_energy_j:.4f}J | latency: "
              f"write={led.write_latency_s:.4f}s read={led.read_latency_s:.4f}s")
    cluster_mod.shutdown()
    return res


def _device_intervals(prof) -> list:
    """``(start_ns, end_ns)`` of every event a profile saw on the card
    (kernels, copies, sets; not the card's copies of host ranges)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        kind = getattr(e, "activity_type", lambda: None)()
        if e.device_type() == cuda and kind != "gpu_user_annotation":
            out.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _traced(path: str, device: str, run):
    """``run()`` with spans recorded and, on a card, under a CUDA-only
    ``torch.profiler``; writes the trace to ``path`` (JSON: the records,
    the counters, host seconds by span and the device's idle seconds by
    the innermost span open on the host, or null without a card) and
    returns what ``run`` returned."""
    cuda = torch.device(device).type == "cuda"
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) if cuda
        else contextlib.nullcontext())
    with spans.recording(), prof:
        out = run()
        if cuda:
            torch.cuda.synchronize()
    recs = spans.records()
    idle = (spans.idle_by_span(_device_intervals(prof), recs) if cuda
            else None)
    doc = {"device": (torch.cuda.get_device_name() if cuda else "cpu"),
           "records": recs, "counters": spans.counters(),
           "seconds_by_span": spans.seconds_by_name(recs),
           "idle_s": None if idle is None else sum(idle.values()),
           "idle_by_span": idle}
    with open(path, "w") as f:
        json.dump(doc, f)
    top = sorted((idle or doc["seconds_by_span"]).items(),
                 key=lambda kv: -kv[1])[:4]
    print(f"trace: {len(recs)} spans "
          f"({doc['counters']['dropped']} dropped), "
          + ("idle" if idle is not None else "host")
          + " " + " ".join(f"{k}={v:.3f}s" for k, v in top)
          + f" -> {path}")
    return out


def _solve_distributed(args, lp, opts):
    """``--backend distributed``: ``solve_dist`` over the local mesh of
    the process group's ranks, or ``solve_dist_auto`` over the cluster's
    with ``--cluster auto``."""
    from ..distributed import solve_dist, solve_dist_auto
    from ..runtime.mesh import make_local_mesh

    if args.cluster != "off":
        return solve_dist_auto(lp, opts, cluster=args.cluster,
                               device=args.torch_device)
    mesh = make_local_mesh(backend=args.dist_backend,
                           device=args.torch_device)
    return solve_dist(lp, mesh, opts)


def _serve_stream(args, opts, info):
    """``--backend batch``: the reference's per-instance lines and, for
    exact streams, its ``stream:`` line (and ``cluster:`` line when the
    buckets are routed)."""
    from ..runtime import BatchSolver, ClusterBatchSolver

    specs = (args.instances or args.instance).split(",")
    lps = [load_instance(s.strip(), seed=args.seed + i)
           for i, s in enumerate(specs)]
    if args.device != "none":
        dev = CROSSBAR_BACKENDS[args.device]
        if args.ecc != 1:
            dev = dataclasses.replace(dev, ecc=args.ecc)
        reports = solve_crossbar_stream(lps, opts, device=dev,
                                        torch_device=args.torch_device)
        for lp, rep in zip(lps, reports):
            r, led = rep.result, rep.ledger
            line = (f"instance={lp.name} shape={lp.K.shape} "
                    f"device={dev.name} status={r.status} "
                    f"iters={r.iterations} objective={r.obj:.6f}")
            if lp.obj_opt is not None:
                rel = abs(r.obj - lp.obj_opt) / max(abs(lp.obj_opt), 1e-12)
                line += (f" (known optimum {lp.obj_opt:.6f}, "
                         f"rel err {rel:.2e})")
            line += (f" | write={led.write_energy_j:.4f}J "
                     f"(padding {led.write_energy_padding_j:.4f}J"
                     + (f", ecc {led.write_energy_ecc_j:.4f}J"
                        if dev.ecc > 1 else "")
                     + f") read={led.read_energy_j:.4f}J")
            if args.refine_rounds:
                line += (f" | refine: rounds={args.refine_rounds} "
                         f"executed_iters={rep.executed_iterations} "
                         f"digital_mvms={rep.digital_mvms}")
            print(line)
        return reports
    if args.sparse:
        lps = [lp.sparsified() for lp in lps]
    n_pods = args.pods if args.pods is not None else info.num_processes
    if n_pods > 1 or info.is_multiprocess:
        solver = ClusterBatchSolver(opts, async_dispatch=not args.sync,
                                    n_pods=n_pods,
                                    norm_reuse=args.norm_reuse,
                                    torch_device=args.torch_device)
    else:
        solver = BatchSolver(opts, async_dispatch=not args.sync,
                             norm_reuse=args.norm_reuse,
                             torch_device=args.torch_device)
    results = solver.solve_stream(lps)
    for lp, r in zip(lps, results):
        line = (f"instance={r.name} shape={lp.K.shape} "
                f"bucket={r.bucket} status={r.status} "
                f"iters={r.iterations} objective={r.obj:.6f}")
        if r.sparse:
            line += f" sparse(nnz={lp.K.nnz})"
        if lp.obj_opt is not None:
            rel = abs(r.obj - lp.obj_opt) / max(abs(lp.obj_opt), 1e-12)
            line += f" (known optimum {lp.obj_opt:.6f}, rel err {rel:.2e})"
        print(line)
    st = solver.last_stream_stats
    print(f"stream: buckets={st['n_buckets']} "
          f"dispatch={st['dispatch_s']:.3f}s "
          f"collect={st['collect_s']:.3f}s "
          f"host_stack_bytes=dense:{st['dense_stack_bytes']}"
          f"/sparse:{st['sparse_stack_bytes']}")
    if "routing" in st:
        print(f"cluster: pod={st['pod']}/{st['n_pods']} "
              f"local_buckets={st['n_local_buckets']} "
              f"rerouted={st['rerouted_buckets']} "
              f"routing={st['routing']}")
    return results


if __name__ == "__main__":
    main()
