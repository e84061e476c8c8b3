"""Quickstart (the PyTorch port): solve an LP on the simulated RRAM
crossbar accelerator.

    PYTHONPATH=src python examples/torch_quickstart.py           # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Walks the paper's full pipeline (Figure 1): generate an instance ->
enhanced PDHG on two simulated RRAM devices and the exact backend ->
compare objective, iterations, energy.  Everything runs in f64.
"""
import argparse

from repro_torch.core import PDHGOptions, solve_jit
from repro_torch.crossbar import EPIRAM, TAOX_HFOX, solve_crossbar_jit
from repro_torch.lp import random_standard_lp


def main(m: int = 96, n: int = 160, max_iters: int = 30000, device=None):
    # A standard-form LP with a known optimum (constructed via
    # complementary slackness — no external solver needed); 96 x 160
    # fills the 256^2 crossbar.
    lp = random_standard_lp(m=m, n=n, seed=0)
    print(f"instance: K {lp.K.shape}, known optimum {lp.obj_opt:.6f}\n")

    opts = PDHGOptions(max_iters=max_iters, tol=1e-6, check_every=100)

    r = solve_jit(lp, opts, device=device)
    print(f"exact PDHG    : obj={r.obj:.6f} "
          f"rel_err={abs(r.obj - lp.obj_opt) / abs(lp.obj_opt):.2e} "
          f"iters={r.iterations}")

    for dev in (EPIRAM, TAOX_HFOX):
        rep = solve_crossbar_jit(lp, opts, device=dev, torch_device=device)
        res, led = rep.result, rep.ledger
        print(f"{dev.name:14s}: obj={res.obj:.6f} "
              f"rel_err={abs(res.obj - lp.obj_opt) / abs(lp.obj_opt):.2e} "
              f"iters={res.iterations} | energy: write "
              f"{led.write_energy_j:.3f} J + read {led.read_energy_j:.3f} J"
              f" | latency {led.total_latency_s:.3f} s")
    print("\nNote how the encode-once write cost is amortized over many "
          "analog MVMs — the paper's core design point.")
    return r


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    main(device=ap.parse_args().device)
