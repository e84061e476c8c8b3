#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # the whole check, one card

Phases, in order; any failure raises and exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
3. kernels: each kernel against its plain PyTorch version on the card, in
   f64 and f32, at a ragged size and at the main path's shape (B6 also
   with a batch of 3 and with zero padding), timed with CUDA events
   beside the plain version and a yardstick;
4. the dense path: the CLI default (``gen-ip002``), then the full-width
   dense instance solved twice, stepped (B1/B2 every step) and with the
   check-window megakernel (B3 every window).  Both must reach
   ``optimal`` on the same iteration count, with the launch counters
   showing each kernel on its path;
5. the crossbar paths: the CLI's ``--backend taox`` and ``--backend
   epiram --refine-rounds 2`` and the host driver on the crossbar
   simulation with B6 (``gen-ip002``, each within the paper's 5e-2
   objective band); then at full width, TaOx-HfOx in f64, the host
   driver with B6 on every MVM, the same driver for 200 iterations with
   and without B6 (the two ``x`` within 1e-9), and ``solve_crossbar_jit``.
   Each path's launch counts are read on their own.

The last lines are one JSON object with every kernel's numbers, the
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or without the repository beside this file, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
from functools import partial
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the main-path instance: dense, f64, the largest rand:Mx2M with
# M >= 2048 that reaches tol=1e-6 within 40000 iterations on a probe of
# M = 2048..4096 in steps of 256 (rand:4096x8192 stops at merit 1.6e-6);
# see PERF.md, "Cells"
MAIN_INSTANCE = "rand:3840x7680"
CHECK_EVERY = 100          # the CLI's window
MAX_ITERS = 40000
TOL = 1e-6

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and the
# highest arithmetic rate for each type (FP64 on the tensor cores, FP32
# outside them).  A bound is the larger of bytes/HBM and ops/peak.
HBM_BYTES_PER_S = 3.35e12
# about 25 ms of device sleep at the H100's ~2 GHz: longer than the host
# takes to enqueue 100 wrapper calls
QUEUE_SLEEP_CYCLES = 50_000_000
PEAK_OPS_PER_S = {"float64": 67e12, "float32": 67e12}

# relative tolerances, kernel against plain version on the same inputs,
# each output's error over that output's own largest |value|
#  B1/B2: one elementwise pass; FMA contraction is the only difference
#  B3:    100 steps; the dot products sum in another order than cuBLAS
#  B6:    one row sum of up to 11520 terms, warp-strided in the kernel
#         and in cuBLAS's order in the plain version
TOLS = {
    ("dual_update", "float64"): 1e-14, ("dual_update", "float32"): 1e-6,
    ("primal_update", "float64"): 1e-14, ("primal_update", "float32"): 1e-6,
    ("fused_dense_steps", "float64"): 1e-12,
    ("fused_dense_steps", "float32"): 1e-5,
    ("crossbar_mvm", "float64"): 1e-13, ("crossbar_mvm", "float32"): 1e-5,
}

KERNEL_NAMES = ("dual_update", "primal_update", "fused_dense_steps",
                "crossbar_mvm")
SOURCES = {
    "dual_update": "src/repro_torch/kernels/csrc/pdhg_kernels.cu",
    "primal_update": "src/repro_torch/kernels/csrc/pdhg_kernels.cu",
    "fused_dense_steps": "src/repro_torch/kernels/csrc/pdhg_kernels.cu",
    "crossbar_mvm": "src/repro_torch/kernels/csrc/crossbar_mvm.cu",
}
REPLACES = {
    "dual_update": "src/repro/kernels/pdhg_update.py:45",
    "primal_update": "src/repro/kernels/pdhg_update.py:34",
    "fused_dense_steps": "src/repro/kernels/pdhg_megakernel.py:74",
    "crossbar_mvm": "src/repro/kernels/crossbar_mvm.py:41",
}

# the crossbar paths: gen-ip002 through the CLI and the host driver
# (iteration budgets cut from the CLI's 40000: the crossbar's noise floor
# stops every solve short of tol=1e-6, so each runs to its budget), and
# the full-width instance on TaOx-HfOx in f64
SMALL_CROSSBAR_ITERS = 10000
HOST_SMALL_ITERS = 6000
OBJ_BAND = 5e-2            # the paper's Table-2 gap band (test_system)
# full-width host driver with B6 on every MVM: an iteration costs two
# reads of G+/G- (2.12 GB each in f64); the budget keeps the phase near
# a minute on the card (PERF.md, "Cells")
HOST_FULL_ITERS = 20000
HOST_AB_ITERS = 200        # kernel against plain product, same seeds
JIT_FULL_ITERS = 5000


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def one_nvcc_build_seconds(_build) -> float:
    """Seconds to build the same library with a single ``nvcc -shared``
    over every source (the form before the build ran one ``nvcc`` per
    source at once), into a scratch directory; the yardstick of the
    build phase's time."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-shared", "-o", os.path.join(tmp, _build.LIB_NAME),
               *(str(_build.CSRC / s) for s in _build.SOURCES)]
        t0 = time.perf_counter()
        subprocess.run(cmd, capture_output=True, check=True, timeout=600)
        return time.perf_counter() - t0


def cuda_ms(fn, reps: int = 20, inner: int = 1, warmup: int = 3,
            queued: bool = False) -> float:
    """Median over ``reps`` samples of the time of one call, each sample
    ``inner`` back-to-back calls between two CUDA events.

    With ``queued`` the card first sleeps for ``QUEUE_SLEEP_CYCLES``
    while the host enqueues the calls, so they run back to back and the
    time is the device's alone; without it, a call whose host side is
    slower than its kernel is timed at its host rate."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / inner)
    return statistics.median(samples)


def max_err(outs, refs):
    """(max abs error, max relative error) over outputs, each output's
    error relative to that output's own largest |reference| value."""
    import torch

    errs = [float(torch.max(torch.abs(o - r))) for o, r in zip(outs, refs)]
    rels = [e / max(float(torch.max(torch.abs(r))), 1e-300)
            for e, r in zip(errs, refs)]
    return max(errs), max(rels)


def bound_ms(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by


# ------------------------------------------------------------- inputs ---

def _vec(g, d, dt, lo=-1.0, hi=1.0):
    import torch

    return lo + (hi - lo) * torch.rand(d, generator=g, dtype=dt,
                                       device="cuda")


def _bounds(g, d, dt):
    """A mix of finite bounds, 0/+inf and -inf/+inf boxes."""
    import torch

    inf = torch.tensor(float("inf"), dtype=dt, device="cuda")
    kind = torch.randint(0, 3, (d,), generator=g, device="cuda")
    lb = torch.where(kind == 0, _vec(g, d, dt, -1.0, -0.1),
                     torch.where(kind == 1, torch.zeros_like(inf), -inf))
    ub = torch.where(kind == 0, _vec(g, d, dt, 0.1, 1.0), inf)
    return lb, ub


def _scalar(v, dt):
    import torch

    return torch.tensor(v, dtype=dt, device="cuda")


def _window_inputs(g, m, n, dt):
    """A well-posed window: K ~ N(0, 1/n), unit diagonals, steps with
    tau * sigma * ||K||^2 < 1, a start inside the bounds."""
    import torch

    K = torch.randn(m, n, generator=g, dtype=dt, device="cuda") / n ** 0.5
    lb, ub = _bounds(g, n, dt)
    x = torch.clamp(_vec(g, n, dt), lb, ub)
    return dict(K=K, K_adj=K.T.contiguous(), b=_vec(g, m, dt),
                c=_vec(g, n, dt), lb=lb, ub=ub,
                T=_vec(g, n, dt, 0.5, 1.0), Sigma=_vec(g, m, dt, 0.5, 1.0),
                x=x, x_prev=x.clone(), x_bar=x.clone(), y=_vec(g, m, dt),
                tau=_scalar(0.3, dt), sigma=_scalar(0.3, dt))


# -------------------------------------------------------------- phases ---

def phase_kernels(m_main: int, n_main: int, steps: int):
    """Every kernel against its plain version; times at the main shape
    (f64, the main path's type) go into the JSON line."""
    import torch

    from repro_torch.core import engine
    from repro_torch.kernels import pdhg_megakernel as mk
    from repro_torch.kernels import pdhg_update as upd

    g = torch.Generator(device="cuda").manual_seed(1234)
    rows = {}
    for dt in (torch.float64, torch.float32):
        dname = str(dt).split(".")[1]
        size = torch.finfo(dt).bits // 8
        for tag, m, n in (("ragged", 777, 1235), ("main", m_main, n_main)):
            # B1 dual update on an (m,) dual vector
            y, kx, b, S = (_vec(g, m, dt) for _ in range(4))
            sigma = _scalar(0.37, dt)
            out = upd.dual_update(y, kx, b, S, sigma)
            ref = upd.dual_update_plain(y, kx, b, S, sigma)
            err, rel = max_err([out], [ref])
            rows.setdefault("dual_update", []).append(dict(
                dtype=dname, shape=[m], max_abs_err=err, rel_err=rel))
            check(rel <= TOLS[("dual_update", dname)],
                  f"dual_update {dname} {tag}: rel err {rel:.3e}")
            if tag == "main":
                call = partial(upd.dual_update, y, kx, b, S, sigma)
                plain = partial(upd.dual_update_plain, y, kx, b, S, sigma)
                rows["dual_update"][-1].update(
                    ms=cuda_ms(call, inner=100, queued=True),
                    call_ms=cuda_ms(call, inner=100),
                    plain_ms=cuda_ms(plain, inner=100, queued=True),
                    library_ms=None,
                    bound=bound_ms((5 * m + 1) * size, 4 * m, dname))
            # B2 primal update on an (n,) primal vector, +-inf bounds
            x, kty, c = (_vec(g, n, dt) for _ in range(3))
            T = _vec(g, n, dt, 0.5, 1.0)
            lb, ub = _bounds(g, n, dt)
            tau, theta = _scalar(0.41, dt), _scalar(0.93, dt)
            outs = upd.primal_update(x, kty, c, T, lb, ub, tau, theta)
            refs = upd.primal_update_plain(x, kty, c, T, lb, ub, tau, theta)
            err, rel = max_err(outs, refs)
            rows.setdefault("primal_update", []).append(dict(
                dtype=dname, shape=[n], max_abs_err=err, rel_err=rel))
            check(rel <= TOLS[("primal_update", dname)],
                  f"primal_update {dname} {tag}: rel err {rel:.3e}")
            if tag == "main":
                args = (x, kty, c, T, lb, ub, tau, theta)
                call = partial(upd.primal_update, *args)
                plain = partial(upd.primal_update_plain, *args)
                rows["primal_update"][-1].update(
                    ms=cuda_ms(call, inner=100, queued=True),
                    call_ms=cuda_ms(call, inner=100),
                    plain_ms=cuda_ms(plain, inner=100, queued=True),
                    library_ms=None,
                    bound=bound_ms((8 * n + 2) * size, 9 * n, dname))
            # B3 check window, with and without the theta schedule
            w = _window_inputs(g, m, n, dt)
            for gamma in (0.0, 0.05):
                outs = mk.fused_dense_steps(**w, n_steps=steps, gamma=gamma)
                refs = mk.fused_dense_steps_plain(**w, n_steps=steps,
                                                  gamma=gamma)
                torch.cuda.synchronize()
                err, rel = max_err(outs, refs)
                rows.setdefault("fused_dense_steps", []).append(dict(
                    dtype=dname, shape=[m, n], steps=steps, gamma=gamma,
                    max_abs_err=err, rel_err=rel))
                check(rel <= TOLS[("fused_dense_steps", dname)],
                      f"fused_dense_steps {dname} {tag} gamma={gamma}: "
                      f"rel err {rel:.3e}")
            if tag == "main":
                op = engine.dense_operator(w["K"], w["K_adj"])
                state0 = engine.PDHGState(w["x"], w["x_prev"], w["x_bar"],
                                          w["y"], w["tau"], w["sigma"])
                vec_args = (w["b"], w["c"], w["lb"], w["ub"], w["T"],
                            w["Sigma"])

                def stepped():
                    # yardstick: cuBLAS GEMVs and the B1/B2 kernels
                    s, xs, ys = state0, 0.0, 0.0
                    for _ in range(steps):
                        s = engine.pdhg_step(op, engine.CUDA_UPDATES,
                                             *vec_args, 0.0, s)
                        xs, ys = xs + s.x, ys + s.y
                    return s, xs, ys

                def gemvs():
                    # the window's two products a step, cuBLAS alone
                    for _ in range(steps):
                        torch.mv(w["K"], w["x_bar"])
                        torch.mv(w["K_adj"], w["y"])

                # reads K, K_adj, b, Sigma, y, c, lb, ub, T, x, x_bar, tau,
                # sigma (x_prev is overwritten unread); writes x, x_prev,
                # x_bar, the x sum, y, the y sum, tau, sigma
                vecs_in = 3 * m + 6 * n + 2
                vecs_out = 4 * n + 2 * m + 2
                rows["fused_dense_steps"][-1].update(
                    ms=cuda_ms(lambda: mk.fused_dense_steps(
                        **w, n_steps=steps, gamma=0.05)),
                    plain_ms=cuda_ms(lambda: mk.fused_dense_steps_plain(
                        **w, n_steps=steps, gamma=0.05)),
                    library_ms=None,
                    yardstick_ms=cuda_ms(stepped),
                    gemv_ms=cuda_ms(gemvs),
                    bound=bound_ms(
                        (2 * m * n + vecs_in + vecs_out) * size,
                        steps * (4 * m * n + 4 * m + 9 * n), dname))
            del w
    for name, checks in rows.items():
        for r in checks:
            print(f"kernel {name} {r['dtype']} shape={r['shape']}"
                  + (f" gamma={r['gamma']}" if "gamma" in r else "")
                  + f" max_abs_err={r['max_abs_err']:.3e}"
                  f" rel_err={r['rel_err']:.3e}"
                  + (f" ms={r['ms']:.6f} plain_ms={r['plain_ms']:.6f}"
                     f" bound_ms={r['bound'][0]:.6f} ({r['bound'][1]})"
                     if "ms" in r else "")
                  + (f" call_ms={r['call_ms']:.6f}" if "call_ms" in r
                     else "")
                  + (f" yardstick_ms={r['yardstick_ms']:.6f}"
                     f" gemv_ms={r['gemv_ms']:.6f}"
                     if "yardstick_ms" in r else ""), flush=True)
    return rows


def phase_crossbar_kernel(dim: int, sigma_read: float):
    """B6 against its plain version: ragged, a batch of 3, zero padding,
    and the full-width symmetric block (dim x dim), timed there beside
    the plain version and cuBLAS reading the same bytes (two GEMVs)."""
    import torch

    from repro_torch.kernels import crossbar_mvm as xb

    g = torch.Generator(device="cuda").manual_seed(4321)
    rows = []
    for dt in (torch.float64, torch.float32):
        dname = str(dt).split(".")[1]
        size = torch.finfo(dt).bits // 8
        tol = TOLS[("crossbar_mvm", dname)]
        for tag, shape in (("ragged", (777, 1235)),
                           ("batch3", (3, 777, 1235)),
                           ("main", (dim, dim))):
            R, C = shape[-2:]
            lead = shape[:-2]
            gp = torch.rand(shape, generator=g, dtype=dt, device="cuda")
            gn = torch.rand(shape, generator=g, dtype=dt, device="cuda")
            v = _vec(g, (*lead, C), dt)
            noise = sigma_read * torch.randn((*lead, R), generator=g,
                                             dtype=dt, device="cuda")
            scale = (torch.tensor([0.5, 0.83, 2.0], dtype=dt, device="cuda")
                     if lead else 0.83)
            out = xb.crossbar_mvm(gp, gn, v, scale, noise)
            ref = xb.crossbar_mvm_plain(gp, gn, v, scale, noise)
            torch.cuda.synchronize()
            err, rel = max_err([out], [ref])
            row = dict(dtype=dname, shape=list(shape), max_abs_err=err,
                       rel_err=rel)
            rows.append(row)
            check(rel <= tol, f"crossbar_mvm {dname} {tag}: rel err "
                              f"{rel:.3e}")
            if tag == "ragged":
                # zero rows and columns of padding change nothing
                pad = torch.nn.functional.pad
                padded = xb.crossbar_mvm(
                    pad(gp, (0, 45, 0, 51)), pad(gn, (0, 45, 0, 51)),
                    pad(v, (0, 45)), scale, pad(noise, (0, 51)))
                torch.cuda.synchronize()
                _, prel = max_err([padded[:R]], [out])
                check(prel <= tol and bool(torch.all(padded[R:] == 0)),
                      f"crossbar_mvm {dname}: zero padding not inert "
                      f"({prel:.3e})")
                row["padding_rel_err"] = prel
            if tag == "main":
                def gemvs():
                    torch.mv(gp, v)
                    torch.mv(gn, v)

                # reads G+, G-, v, noise and the scale; writes w
                row.update(
                    ms=cuda_ms(lambda: xb.crossbar_mvm(gp, gn, v, scale,
                                                       noise),
                               reps=10, inner=10),
                    plain_ms=cuda_ms(lambda: xb.crossbar_mvm_plain(
                        gp, gn, v, scale, noise), reps=5, inner=2),
                    library_ms=None,
                    gemv_ms=cuda_ms(gemvs, reps=10, inner=10),
                    bound=bound_ms((2 * R * C + C + 2 * R + 1) * size,
                                   3 * R * C + 2 * R, dname))
            del gp, gn, out, ref
            torch.cuda.empty_cache()
    for r in rows:
        print(f"kernel crossbar_mvm {r['dtype']} shape={r['shape']}"
              f" max_abs_err={r['max_abs_err']:.3e}"
              f" rel_err={r['rel_err']:.3e}"
              + (f" padding_rel_err={r['padding_rel_err']:.3e}"
                 if "padding_rel_err" in r else "")
              + (f" ms={r['ms']:.6f} plain_ms={r['plain_ms']:.6f}"
                 f" gemv_ms={r['gemv_ms']:.6f}"
                 f" bound_ms={r['bound'][0]:.6f} ({r['bound'][1]})"
                 if "ms" in r else ""), flush=True)
    return rows


def _timed(fn):
    """Run ``fn`` from a synchronised card; return (out, wall, peak)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, torch.cuda.max_memory_allocated()


def _run(label, fn):
    res, wall, peak = _timed(fn)
    print(f"main {label}: status={res.status} iterations={res.iterations} "
          f"merit={res.merit:.3e} wall_s={wall:.3f} "
          f"max_memory_allocated={peak}", flush=True)
    return res, wall


def _counted(fn):
    """Run ``fn`` with every launch count set to 0 just before it; return
    its result and the counts read just after."""
    from repro_torch import kernels

    kernels.reset_launch_counts()
    out = fn()
    return out, kernels.launch_counts()


def phase_main(instance: str):
    """The port's main path through its entry points; returns each
    path's own launch counts."""
    from repro_torch.core import engine
    from repro_torch.core.pdhg import PDHGOptions, solve_jit
    from repro_torch.launch import solve as cli

    # the CLI default: gen-ip002, stepped, CUDA update kernels
    (res0, _), cli_counts = _counted(lambda: _run(
        "cli gen-ip002", lambda: cli.main(["--instance", "gen-ip002"])))
    lp0 = cli.load_instance("gen-ip002")
    rel0 = abs(res0.obj - lp0.obj_opt) / abs(lp0.obj_opt)
    print(f"main cli gen-ip002: launches={cli_counts}", flush=True)
    check(res0.status == "optimal" and rel0 <= 1e-4,
          f"gen-ip002: {res0.status}, rel err {rel0:.3e}")
    want0 = {"dual_update": res0.iterations,
             "primal_update": res0.iterations, "fused_dense_steps": 0,
             "crossbar_mvm": 0}
    check(cli_counts == want0,
          f"gen-ip002 launches {cli_counts}, expected {want0}")
    counts = {"cli gen-ip002": cli_counts}

    t0 = time.perf_counter()
    lp = cli.load_instance(instance)
    print(f"main {instance}: generated in {time.perf_counter() - t0:.3f}s",
          flush=True)
    opts = PDHGOptions(max_iters=MAX_ITERS, tol=TOL,
                       check_every=CHECK_EVERY)
    results = {}
    for label, o in (("stepped", opts),
                     ("megakernel", dataclasses.replace(opts,
                                                        megakernel=True))):
        (res, wall), delta = _counted(lambda: _run(
            f"{instance} {label}", lambda: solve_jit(lp, o)))
        rel = abs(res.obj - lp.obj_opt) / abs(lp.obj_opt)
        print(f"main {instance} {label}: objective={res.obj:.9f} "
              f"known={lp.obj_opt:.9f} rel_err={rel:.3e} "
              f"mvm_calls={res.mvm_calls} launches={delta}", flush=True)
        check(res.status == "optimal" and rel <= 1e-4,
              f"{instance} {label}: {res.status}, rel err {rel:.3e}")
        check(res.mvm_calls == engine.mvm_accounting(
            res.iterations, CHECK_EVERY, opts.lanczos_iters, restart=True),
            f"{instance} {label}: mvm_calls {res.mvm_calls}")
        windows = res.iterations // CHECK_EVERY
        want = ({"dual_update": res.iterations,
                 "primal_update": res.iterations, "fused_dense_steps": 0,
                 "crossbar_mvm": 0}
                if label == "stepped" else
                {"dual_update": 0, "primal_update": 0,
                 "fused_dense_steps": windows, "crossbar_mvm": 0})
        check(delta == want, f"{instance} {label}: launches {delta}, "
                             f"expected {want}")
        results[label] = (res, wall)
        counts[label] = delta
    (ra, _), (rb, _) = results["stepped"], results["megakernel"]
    dx = float(abs(ra.x - rb.x).max())
    print(f"main {instance}: stepped vs megakernel max|dx|={dx:.3e}",
          flush=True)
    check(ra.iterations == rb.iterations,
          f"iterations differ: {ra.iterations} vs {rb.iterations}")
    check(dx <= 1e-8, f"x differs by {dx:.3e}")
    return counts


def _ledger_line(led) -> str:
    return (f"ledger write_energy_j={led.write_energy_j:.6e} "
            f"write_latency_s={led.write_latency_s:.6e} "
            f"read_energy_j={led.read_energy_j:.6e} "
            f"read_latency_s={led.read_latency_s:.6e} "
            f"mvm_count={led.mvm_count} cells_written={led.cells_written}")


def phase_crossbar(instance: str):
    """The crossbar paths through their entry points; returns each
    path's own launch counts."""
    import numpy as np

    from repro_torch.core.pdhg import PDHGOptions, solve
    from repro_torch.crossbar import (
        TAOX_HFOX,
        crossbar_accel_factory,
        solve_crossbar_jit,
    )
    from repro_torch.launch import solve as cli

    counts = {}
    lp0 = cli.load_instance("gen-ip002")

    def band(label, res):
        rel = abs(res.obj - lp0.obj_opt) / abs(lp0.obj_opt)
        print(f"crossbar {label}: objective={res.obj:.9f} "
              f"known={lp0.obj_opt:.9f} rel_err={rel:.3e}", flush=True)
        check(np.isfinite(res.obj) and rel <= OBJ_BAND,
              f"{label}: rel err {rel:.3e} outside {OBJ_BAND}")

    # the CLI's crossbar backends: solve_crossbar_jit on decoded
    # conductances, B1/B2 every step and no B6
    for label, args in (
            ("cli taox", ["--backend", "taox"]),
            ("cli epiram refine", ["--backend", "epiram",
                                   "--refine-rounds", "2"])):
        (res, wall, peak), delta = _counted(lambda: _timed(
            lambda: cli.main(
                [*args, "--max-iters", str(SMALL_CROSSBAR_ITERS)])))
        print(f"crossbar {label}: status={res.status} "
              f"iterations={res.iterations} merit={res.merit:.3e} "
              f"mvm_calls={res.mvm_calls} wall_s={wall:.3f} "
              f"max_memory_allocated={peak} launches={delta}", flush=True)
        band(label, res)
        want = {"dual_update": res.iterations,
                "primal_update": res.iterations, "fused_dense_steps": 0,
                "crossbar_mvm": 0}
        check(delta == want, f"{label}: launches {delta}, expected {want}")
        counts[label] = delta

    def host(label, lp, iters, use_kernel, stamps=None):
        fac = crossbar_accel_factory(TAOX_HFOX, use_kernel=use_kernel)
        cb = None if stamps is None else (
            lambda it, merit, acc: stamps.append((it, merit)))
        opts = PDHGOptions(max_iters=iters, check_every=CHECK_EVERY)
        (res, wall, peak), delta = _counted(lambda: _timed(
            lambda: solve(lp, opts, accel_factory=fac, on_iteration=cb)))
        led = fac.ledger
        print(f"crossbar {label}: status={res.status} "
              f"iterations={res.iterations} merit={res.merit:.3e} "
              f"mvm_calls={res.mvm_calls} wall_s={wall:.3f} "
              f"max_memory_allocated={peak} launches={delta} "
              f"{_ledger_line(led)}", flush=True)
        check(res.mvm_calls == led.mvm_count,
              f"{label}: mvm_calls {res.mvm_calls} != ledger "
              f"{led.mvm_count}")
        want = {"dual_update": res.iterations,
                "primal_update": res.iterations, "fused_dense_steps": 0,
                "crossbar_mvm": res.mvm_calls if use_kernel else 0}
        check(delta == want, f"{label}: launches {delta}, expected {want}")
        counts[label] = delta
        return res

    # the host driver on the crossbar simulation, B6 on every MVM
    band("host gen-ip002", host("host gen-ip002", lp0, HOST_SMALL_ITERS,
                                True))

    t0 = time.perf_counter()
    lp = cli.load_instance(instance)
    print(f"crossbar {instance}: generated in "
          f"{time.perf_counter() - t0:.3f}s", flush=True)
    # (a) full width, B6 on every MVM: the merit must fall
    stamps = []
    res = host("host full", lp, HOST_FULL_ITERS, True, stamps)
    first = stamps[0][1]
    check(np.isfinite(res.merit) and res.merit < first,
          f"host full: merit {res.merit:.3e} not below its first check "
          f"{first:.3e}")
    print(f"crossbar host full: merit at first check {first:.3e}, "
          f"at exit {res.merit:.3e}", flush=True)
    # (b) the same seeds through B6 and through the plain product
    ra = host("host full kernel 200", lp, HOST_AB_ITERS, True)
    rb = host("host full plain 200", lp, HOST_AB_ITERS, False)
    dx = float(np.max(np.abs(ra.x - rb.x)))
    print(f"crossbar host full 200: kernel vs plain max|dx|={dx:.3e}",
          flush=True)
    check(ra.iterations == rb.iterations and dx <= 1e-9,
          f"host full 200: kernel and plain differ by {dx:.3e}")
    # (c) the device-resident crossbar solve on decoded conductances
    opts = PDHGOptions(max_iters=JIT_FULL_ITERS, check_every=CHECK_EVERY)
    (rep, wall, peak), delta = _counted(lambda: _timed(
        lambda: solve_crossbar_jit(lp, opts, device=TAOX_HFOX)))
    r, led = rep.result, rep.ledger
    print(f"crossbar jit full: status={r.status} iterations={r.iterations} "
          f"merit={r.merit:.3e} mvm_calls={r.mvm_calls} wall_s={wall:.3f} "
          f"max_memory_allocated={peak} launches={delta} "
          f"{_ledger_line(led)}", flush=True)
    # M is (m+n)^2, padded to whole 64x64 tiles (none at 11520)
    tile = TAOX_HFOX.crossbar_rows
    dim = -(-sum(lp.K.shape) // tile) * tile
    check(led.cells_written == 2 * dim * dim,
          f"jit full: cells_written {led.cells_written} != 2*{dim}^2")
    check(led.mvm_count == r.mvm_calls and np.isfinite(r.merit),
          f"jit full: mvm_count {led.mvm_count}, mvm_calls {r.mvm_calls}")
    check(delta == {"dual_update": r.iterations,
                    "primal_update": r.iterations, "fused_dense_steps": 0,
                    "crossbar_mvm": 0}, f"jit full: launches {delta}")
    counts["jit full"] = delta
    return counts


# the full-width path on which each kernel's ``launches`` is read
MAIN_PATH_OF = {"dual_update": "stepped", "primal_update": "stepped",
                "fused_dense_steps": "megakernel",
                "crossbar_mvm": "host full"}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 1
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {HERE}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)

    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import _build

    built = _build.build(verbose=True)
    print(f"build: {built.seconds:.1f}s -> {built.path}", flush=True)
    for line in built.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"  ptxas {line.strip()}", flush=True)
    print(f"build yardstick: one nvcc over all sources "
          f"{one_nvcc_build_seconds(_build):.1f}s", flush=True)

    from repro_torch.crossbar import TAOX_HFOX

    m, n = (int(v) for v in MAIN_INSTANCE.split(":")[1].split("x"))
    rows = phase_kernels(m, n, CHECK_EVERY)
    rows["crossbar_mvm"] = phase_crossbar_kernel(m + n, TAOX_HFOX.sigma_read)
    counts = phase_main(MAIN_INSTANCE)
    counts.update(phase_crossbar(MAIN_INSTANCE))

    line = []
    for name in KERNEL_NAMES:
        main_row = next(r for r in rows[name]
                        if r["dtype"] == "float64" and "ms" in r)
        entry = {
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": counts[MAIN_PATH_OF[name]][name],
            "launches_by_path": {path: c[name] for path, c in counts.items()},
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]
                               if r["dtype"] == "float64"),
            "rel_err": max(r["rel_err"] for r in rows[name]
                           if r["dtype"] == "float64"),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound"][0],
            "bound_by": main_row["bound"][1],
            "library_ms": main_row["library_ms"],
            "shape": main_row["shape"], "dtype": "float64",
        }
        for extra in ("call_ms", "yardstick_ms", "gemv_ms"):
            if extra in main_row:
                entry[extra] = main_row[extra]
        f32 = next(r for r in rows[name]
                   if r["dtype"] == "float32" and "ms" in r)
        entry["f32"] = {"ms": f32["ms"], "plain_ms": f32["plain_ms"],
                        "bound_ms": f32["bound"][0],
                        "max_abs_err": max(r["max_abs_err"] for r in rows[name]
                                           if r["dtype"] == "float32"),
                        "rel_err": max(r["rel_err"] for r in rows[name]
                                       if r["dtype"] == "float32")}
        for extra in ("call_ms", "yardstick_ms", "gemv_ms"):
            if extra in f32:
                entry["f32"][extra] = f32[extra]
        line.append(entry)
    print(json.dumps({"kernels": line}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
