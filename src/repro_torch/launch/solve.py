"""The port's LP solving CLI — the paper's workload on one card.

  PYTHONPATH=src python -m repro_torch.launch.solve --instance gen-ip002
  PYTHONPATH=src python -m repro_torch.launch.solve --instance rand:64x128 \
      --megakernel                 # one CUDA launch per check window
  PYTHONPATH=src python -m repro_torch.launch.solve --torch-device cpu \
      --kernel torch               # plain PyTorch on the CPU

Only ``--backend exact`` (the dense ``solve_jit``) is ported; the other
backends of ``repro.launch.solve`` exit with an error that names the
ROADMAP item bringing them.  ``--device`` stays reserved for the
crossbar device model, as in the reference; the hardware is chosen with
``--torch-device``.
"""
from __future__ import annotations

import argparse

from ..core.engine import KERNELS, STEP_RULES
from ..core.lanczos import NORM_BACKENDS
from ..core.pdhg import PDHGOptions, solve_jit
from ..lp import (
    TABLE1_SIZES,
    pagerank_lp,
    random_standard_lp,
    sparse_random_standard_lp,
    table1_instance,
)

# backends of the reference CLI that later slices bring (ROADMAP queue A)
NOT_PORTED = {
    "epiram": "A4 (crossbar and host loop)",
    "taox": "A4 (crossbar and host loop)",
    "batch": "A5 (bucketed batch serving)",
    "distributed": "A6 (distributed and cluster)",
}


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
                    choices=["exact", *NOT_PORTED])
    ap.add_argument("--kernel", default="cuda", choices=KERNELS,
                    help="update backend: the hand-written CUDA kernels "
                         "(their plain versions on CPU tensors) or plain "
                         "PyTorch; the counterparts of the reference's "
                         "pallas | jnp")
    ap.add_argument("--megakernel", action="store_true",
                    help="run each check window as one CUDA launch")
    ap.add_argument("--torch-device", default="cuda",
                    choices=["cuda", "cpu"],
                    help="hardware the solve runs on")
    ap.add_argument("--step-rule", default="fixed", choices=STEP_RULES)
    ap.add_argument("--gamma", type=float, default=0.0,
                    help="strong-convexity modulus for "
                         "--step-rule strongly_convex")
    ap.add_argument("--norm-backend", default="lanczos",
                    choices=NORM_BACKENDS)
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--max-iters", type=int, default=40000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.backend in NOT_PORTED:
        ap.error(f"--backend {args.backend} is not ported yet; ROADMAP "
                 f"item {NOT_PORTED[args.backend]} brings it")

    opts = PDHGOptions(max_iters=args.max_iters, tol=args.tol,
                       check_every=100, seed=args.seed,
                       kernel=args.kernel, megakernel=args.megakernel,
                       step_rule=args.step_rule, gamma=args.gamma,
                       norm_backend=args.norm_backend)
    lp = load_instance(args.instance, seed=args.seed)
    res = solve_jit(lp, opts, device=args.torch_device)

    print(f"instance={lp.name} shape={lp.K.shape} backend={args.backend}")
    print(f"status={res.status} iters={res.iterations} "
          f"sigma_max={res.sigma_max:.6f}")
    print(f"objective={res.obj:.6f}"
          + (f" (known optimum {lp.obj_opt:.6f}, "
             f"rel err {abs(res.obj-lp.obj_opt)/max(abs(lp.obj_opt),1e-12):.2e})"
             if lp.obj_opt is not None else ""))
    return res


if __name__ == "__main__":
    main()
