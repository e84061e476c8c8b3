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

``--backend exact`` runs the dense ``solve_jit``; ``epiram``/``taox``
run ``crossbar.solve_crossbar_jit`` on that device model.  ``batch`` and
``distributed`` exit with an error that names the ROADMAP item bringing
them.  ``--device`` stays reserved for the crossbar device model of the
batch stream, as in the reference; the hardware is chosen with
``--torch-device``.
"""
from __future__ import annotations

import argparse
import dataclasses

from ..core.engine import KERNELS, STEP_RULES
from ..core.lanczos import NORM_BACKENDS
from ..core.pdhg import PDHGOptions, solve_jit
from ..crossbar import EPIRAM, TAOX_HFOX, solve_crossbar_jit
from ..lp import (
    TABLE1_SIZES,
    pagerank_lp,
    random_standard_lp,
    sparse_random_standard_lp,
    table1_instance,
)

# backends of the reference CLI that later slices bring (ROADMAP queue A)
NOT_PORTED = {
    "batch": "A5 (bucketed batch serving)",
    "distributed": "A6 (distributed and cluster)",
}
CROSSBAR_BACKENDS = {"epiram": EPIRAM, "taox": TAOX_HFOX}


def load_instance(spec: str, seed: int = 0):
    if spec in TABLE1_SIZES:
        return table1_instance(spec, seed=seed)
    if spec.startswith("rand:"):
        m, n = spec[5:].split("x")
        return random_standard_lp(int(m), int(n), seed=seed)
    if spec.startswith("sprand:"):
        # sprand:MxN[:density] — COO-native sparse instance (densified by
        # the dense solve)
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
    ap.add_argument("--backend", default="exact",
                    choices=["exact", *CROSSBAR_BACKENDS, *NOT_PORTED])
    ap.add_argument("--kernel", default="cuda", choices=KERNELS,
                    help="update backend: the hand-written CUDA kernels "
                         "(their plain versions on CPU tensors) or plain "
                         "PyTorch; the counterparts of the reference's "
                         "pallas | jnp")
    ap.add_argument("--megakernel", action="store_true",
                    help="run each check window as one CUDA launch "
                         "(noiseless: --backend exact only)")
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
    args = ap.parse_args(argv)
    if args.backend in NOT_PORTED:
        ap.error(f"--backend {args.backend} is not ported yet; ROADMAP "
                 f"item {NOT_PORTED[args.backend]} brings it")
    crossbar_backend = args.backend in CROSSBAR_BACKENDS
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

    opts = PDHGOptions(max_iters=args.max_iters, tol=args.tol,
                       check_every=100, seed=args.seed,
                       kernel=args.kernel, megakernel=args.megakernel,
                       step_rule=args.step_rule, gamma=args.gamma,
                       norm_backend=args.norm_backend,
                       refine_rounds=args.refine_rounds,
                       refine_tol=args.refine_tol)
    lp = load_instance(args.instance, seed=args.seed)
    led = None
    if crossbar_backend:
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
    return res


if __name__ == "__main__":
    main()
