#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                 # the whole check, one card
    python3 chip_smoke.py --probe 128,96,64
        # only the full-width sparse stream, stepped, within the CLI's
        # 40000 iterations, at each scale of the stream shapes, to find
        # the largest at which every instance reaches tol (prints one
        # "probe" line a scale)
    python3 chip_smoke.py --lm            # only phase 9, the LM serving
    python3 chip_smoke.py --train         # only phase 10, the LM training

Phases, in order; any failure raises and exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the hand-written kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, all at once);
3. kernels: each kernel against its plain PyTorch version on the card, in
   f64 and f32, at a ragged size and at the main path's shape (B1 and B2
   also in their step forms, with the window's schedule, and a stepped
   window of 100 steps timed eagerly and as a CUDA graph; B6 also
   with a batch of 3 and with zero padding; B4 and B5 also with a batch
   of 3 and at width 0, each with and without row lengths, B4 also with
   a strided v and v[0] = inf, B5 also with half its lanes masked off;
   both forms of B3 also with a batch of 3, tiny lanes, more lanes than
   SMs, rows too long for the transpose form's ring, and half their
   lanes masked off; B1-B3 also batched), timed with CUDA events beside
   the plain version and a yardstick; B4's, B5's and B3's transpose
   form's registers and resident blocks an SM;
4. the dense path: the CLI default (``gen-ip002``), then the full-width
   dense instance solved three times: stepped as a CUDA graph a window
   (the schedule once a window, B1's and B2's step forms every step),
   the same with every window eager (``engine.solve_core(...,
   graph=False)``: the same iterations, ``x`` bit for bit, the same
   launches, each counted where it launches), and with the
   check-window megakernel (B3's transpose form every window, its
   two-matrix form never).  All must reach ``optimal`` on the same
   iteration count, with the launch counters showing each kernel on its
   path;
5. the crossbar paths: the CLI's ``--backend taox`` and ``--backend
   epiram --refine-rounds 2`` and the host driver on the crossbar
   simulation with B6 (``gen-ip002``, each within the paper's 5e-2
   objective band); then at full width, TaOx-HfOx in f64, the host
   driver with B6 on every MVM (B1 and B2 every step: the host driver
   steps ``engine.pdhg_step``), the same driver for 200 iterations with
   and without B6 (the two ``x`` within 1e-9), ``solve_crossbar_jit``,
   and ``solve_crossbar_jit`` on a noiseless TaOx-HfOx stepped and with
   the megakernel (B3's two-matrix form on the programmed blocks every
   window; the two on the same iteration count, ``x`` within 1e-8).
   Each path's launch counts are read on their own;
6. the small batch streams through the CLI (``--backend batch``: dense
   stepped, as a graph and eagerly, and with ``--megakernel``,
   ``--sparse``, and ``--device taox --kernel cuda`` with B6 batched);
7. the full-width sparse stream (16 MIPLIB-2017-class LP relaxations in
   two ELL width buckets: (64, 32) with 16 lanes, 12 real and 4 filler,
   and (64, 64) with 4) through ``BatchSolver``: stepped (B4 on every
   MVM, the step forms every step, a CUDA graph a window on each
   bucket's stream), the same eagerly (the same iterations, ``x`` bit
   for bit, the same launches), then with the megakernel (B5 every
   window), the same iterations and ``x`` within 1e-8, every launch
   counted, and a warm pass that builds nothing;
8. the distributed path (``distributed.solve_dist``), each rank a
   process of this script started with a timeout: the full-width dense
   instance on a 1x1 mesh over NCCL (the stepped ``solve_jit``'s
   iterations, ``x`` within 1e-10; the schedule, B1's and B2's step
   forms counted), then 2000 steps on it and on a 2x2 mesh of four
   ranks time-sharing the one card over gloo with CUDA tensors (the same
   iterations, ``x`` within 1e-9; ``compressed_psum`` within its bound
   of the exact all-reduce), the time inside the all-reduces printed;
   and two pods of ``ClusterBatchSolver`` over a ``DirectoryTransport``
   on the small dense stream, bitwise one ``BatchSolver``'s;
9. the LM serving path (``repro_torch.models``, ``train.serve_step``,
   no hand-written kernel: every launch count stays 0): for each of the
   ten configs at its published widths, 2 layers, f32, token-by-token
   ``decode_step`` against ``forward`` at the reference test's
   tolerance; then in bf16 ``granite-3-8b`` whole (8 prompts of 1024
   tokens through ``make_prefill_step``, the cache filled by
   ``lm.prefill_cache``, 64 greedy tokens through ``make_serve_step``
   from the prompts' last token, a cache of 1088 slots), every
   other config that fits the card whole (8 x 256 tokens, 32 new), and
   ``grok-1-314b`` at 2 layers (printed as reduced): prefill and decode
   times, tokens/s, peak memory, and the decode path's last logits
   against prefill's;
10. the LM training path (``train.make_train_step``, the optimizers,
   ``train.synth_batch``; autograd over torch matmuls, no hand-written
   kernel and no CUDA graph: every launch count and ``engine.GRAPHS``
   stay as they were): for each of the ten configs at its published
   widths, 2 layers, f32, 2 x 64 tokens (MoE at a dropless capacity),
   one AdamW step whose loss equals ``cross_entropy(forward(...))``,
   finite gradients, the f32 gradients against an f64 copy's and
   ``remat=True`` against ``remat=False`` (``grok-1-314b`` at 1 layer
   in bf16 with Adafactor, loss and finiteness only); then
   ``starcoder2-3b`` (AdamW) and ``granite-3-8b`` (Adafactor) trained
   whole in bf16 with remat, 8 x 1024 tokens a step for 10 steps: ms a
   step, tokens/s, MFU, peak memory, loss falling; on granite one
   ``microbatch=2`` step against the plain step from the same state;
11. the dry run (``repro_torch.launch.dryrun``) on the host's CPU (a
   fake process group of 512 ranks, ``meta`` DTensors; it launches
   nothing on the card), three cells at 2 layers, each in a process of
   its own, all at once: the reference's decode cell, ``starcoder2-3b``
   ``decode_32k`` on the 2x16x16 mesh (its peak a device under the
   reference test's 16 GiB), ``olmoe-1b-7b`` ``train_4k`` on 2x16x16
   and ``qwen3-14b`` ``prefill_32k`` on 16x16; with the machine's torch
   printed, each cell's peak, FLOPs and collective bytes a device are
   held within 1 % of the counts another torch gave (``DRYRUN_COUNTS``).

The last lines are one JSON object with every kernel's numbers, the
``nvidia-smi`` line, and ``{"ok": true, "device": {...}}``.  Without a
CUDA card, or without the repository beside this file, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import contextlib
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
#         (their step forms too; the schedule: theta's 1 + 2 gamma tau
#         may be contracted)
#  B3:    100 steps; the dot products sum in another order than cuBLAS
#  B6:    one row sum of up to 11520 terms, warp-strided in the kernel
#         and in cuBLAS's order in the plain version
#  B4:    one row sum of up to 64 ELL slots, group-strided in the kernel
#         and in torch's order in the plain version
#  B5:    100 steps of B4's row sums and B1/B2's algebra, as B3
TOLS = {
    ("dual_update", "float64"): 1e-14, ("dual_update", "float32"): 1e-6,
    ("primal_update", "float64"): 1e-14, ("primal_update", "float32"): 1e-6,
    ("fused_dense_steps", "float64"): 1e-12,
    ("fused_dense_steps", "float32"): 1e-5,
    ("fused_dense_steps_kt", "float64"): 1e-12,
    ("fused_dense_steps_kt", "float32"): 1e-5,
    ("ell_matvec", "float64"): 1e-13, ("ell_matvec", "float32"): 1e-5,
    ("fused_ell_steps", "float64"): 1e-12,
    ("fused_ell_steps", "float32"): 1e-5,
    ("crossbar_mvm", "float64"): 1e-13, ("crossbar_mvm", "float32"): 1e-5,
    ("dual_step", "float64"): 1e-14, ("dual_step", "float32"): 1e-6,
    ("primal_step", "float64"): 1e-14, ("primal_step", "float32"): 1e-6,
    ("schedule", "float64"): 1e-14, ("schedule", "float32"): 1e-6,
}

KERNEL_NAMES = ("dual_update", "primal_update", "fused_dense_steps",
                "ell_matvec", "fused_ell_steps", "crossbar_mvm",
                "fused_dense_steps_kt", "schedule", "dual_step",
                "primal_step")
SOURCES = {
    "dual_update": "src/repro_torch/kernels/csrc/pdhg_kernels.cu",
    "primal_update": "src/repro_torch/kernels/csrc/pdhg_kernels.cu",
    "fused_dense_steps": "src/repro_torch/kernels/csrc/pdhg_kernels.cu",
    "ell_matvec": "src/repro_torch/kernels/csrc/sparse_mvm.cu",
    "fused_ell_steps": "src/repro_torch/kernels/csrc/pdhg_kernels.cu",
    "crossbar_mvm": "src/repro_torch/kernels/csrc/crossbar_mvm.cu",
    "fused_dense_steps_kt": "src/repro_torch/kernels/csrc/pdhg_kernels.cu",
    "schedule": "src/repro_torch/kernels/csrc/pdhg_kernels.cu",
    "dual_step": "src/repro_torch/kernels/csrc/pdhg_kernels.cu",
    "primal_step": "src/repro_torch/kernels/csrc/pdhg_kernels.cu",
}
# the step forms are B1's and B2's redesign for the stepped window; the
# schedule is the third launch of that design (the step sizes B2 reads),
# which the reference computes in XLA inside its while_loop
REPLACES = {
    "dual_update": "src/repro/kernels/pdhg_update.py:45",
    "primal_update": "src/repro/kernels/pdhg_update.py:34",
    "fused_dense_steps": "src/repro/kernels/pdhg_megakernel.py:74",
    "ell_matvec": "src/repro/kernels/sparse_mvm.py:119",
    "fused_ell_steps": "src/repro/kernels/pdhg_megakernel.py:95",
    "crossbar_mvm": "src/repro/kernels/crossbar_mvm.py:41",
    "fused_dense_steps_kt": "src/repro/kernels/pdhg_megakernel.py:74",
    "schedule": "src/repro/kernels/pdhg_update.py:34",
    "dual_step": "src/repro/kernels/pdhg_update.py:45",
    "primal_step": "src/repro/kernels/pdhg_update.py:34",
}

# the full-width sparse stream: the reference's SPARSE_STREAM_SHAPES
# scaled up (MIPLIB-2017-class relaxations run 1e4-1e6 nonzeros at
# fractions of a percent density), 16 instances, seeds 0-15, f64,
# tol=1e-6, check_every=100; probed with ``--probe``
STREAM_SCALE = 128
STREAM_INSTANCES = 16
STREAM_DENSITY = 1e-3
# no scale of 128, 96, 64, 48, 32, 24 or 16 brings every instance to tol
# within the CLI's 40000 iterations (fixed or adaptive steps); at 128
# every one gets there within 160000 (the slowest in 111400), so the
# stream keeps its full scale and takes that budget (PERF.md, "Cells")
STREAM_MAX_ITERS = 160000
# the small streams of the CLI (the reference's documented specs)
SMALL_DENSE = "rand:8x14,rand:10x18,rand:24x40"
SMALL_SPARSE = "sprand:96x192:0.05,sprand:128x256:0.02"
SMALL_STREAM_CROSSBAR_ITERS = 10000
# the distributed phase: the fixed budget of its 1x1 / 2x2 comparison,
# and each spawned group's time limit
DIST_BUDGET = 2000
DIST_TIMEOUT_S = 300


def launches(**nonzero) -> dict:
    """Every kernel's expected launch count: 0 unless given."""
    out = {name: 0 for name in KERNEL_NAMES}
    out.update(nonzero)
    return out

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
# the noiseless crossbar with the megakernel: B3's two-matrix form on the
# programmed blocks (K_fwd and K_adj are distinct cells)
JIT_NOISELESS_ITERS = 2000


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
    kind = torch.randint(0, 3, d if isinstance(d, tuple) else (d,),
                         generator=g, device="cuda")
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

    def held(name, dname, shape, outs, refs, tag):
        err, rel = max_err(outs, refs)
        rows.setdefault(name, []).append(dict(
            dtype=dname, shape=shape, max_abs_err=err, rel_err=rel))
        check(rel <= TOLS[(name, dname)],
              f"{name} {dname} {tag}: rel err {rel:.3e}")

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
            # the stepped window's forms: the schedule of a window, then
            # B1's and B2's step forms on a slot of it, the sums folded in
            sigma0 = _scalar(0.29, dt)
            sched = upd.schedule(tau, sigma0, steps, 0.05)
            held("schedule", dname, [steps], sched,
                 upd.schedule_plain(tau, sigma0, steps, 0.05), tag)
            ys = _vec(g, m, dt)
            ys_k, ys_p = ys.clone(), ys.clone()
            out = upd.dual_step(y, kx, b, S, sched[0][1, 7], ys_k)
            ref = upd.dual_step_plain(y, kx, b, S, sched[0][1, 7], ys_p)
            held("dual_step", dname, [m], [out, ys_k], [ref, ys_p], tag)
            check(torch.equal(ys_k, ys + out),
                  f"dual_step {dname} {tag}: the sum is not ys + y'")
            xs = _vec(g, n, dt)
            xs_k, xs_p = xs.clone(), xs.clone()
            outs = upd.primal_step(x, kty, c, T, lb, ub, sched[0][0, 7],
                                   sched[0][2, 7], xs_k)
            refs = upd.primal_step_plain(x, kty, c, T, lb, ub,
                                         sched[0][0, 7], sched[0][2, 7],
                                         xs_p)
            held("primal_step", dname, [n], [*outs, xs_k], [*refs, xs_p],
                 tag)
            check(torch.equal(xs_k, xs + outs[0]),
                  f"primal_step {dname} {tag}: the sum is not xs + x'")
            if tag == "main":
                bufs = upd.schedule_buffers(tau, steps)
                y_out, x_new, x_bar = (torch.empty_like(y),
                                       torch.empty_like(x),
                                       torch.empty_like(x))
                timed = {
                    # reads tau, sigma; writes the schedule, tau, sigma
                    "schedule": (
                        partial(upd.schedule, tau, sigma0, steps, 0.05,
                                bufs),
                        partial(upd.schedule_plain, tau, sigma0, steps,
                                0.05, bufs),
                        bound_ms((3 * steps + 4) * size, 7 * steps, dname)),
                    # reads y, Kx, b, Sigma, the y sum and sigma; writes
                    # y' and the y sum
                    "dual_step": (
                        partial(upd.dual_step, y, kx, b, S, sched[0][1, 7],
                                ys_k, y_out),
                        partial(upd.dual_step_plain, y, kx, b, S,
                                sched[0][1, 7], ys_p, y_out),
                        bound_ms((7 * m + 1) * size, 5 * m, dname)),
                    # reads x, K^T y, c, T, lb, ub, the x sum, tau, theta;
                    # writes x', x_bar and the x sum
                    "primal_step": (
                        partial(upd.primal_step, x, kty, c, T, lb, ub,
                                sched[0][0, 7], sched[0][2, 7], xs_k, x_new,
                                x_bar),
                        partial(upd.primal_step_plain, x, kty, c, T, lb, ub,
                                sched[0][0, 7], sched[0][2, 7], xs_p, x_new,
                                x_bar),
                        bound_ms((10 * n + 2) * size, 10 * n, dname)),
                }
                for name, (call, plain, bound) in timed.items():
                    rows[name][-1].update(
                        ms=cuda_ms(call, inner=100, queued=True),
                        call_ms=cuda_ms(call, inner=100),
                        plain_ms=cuda_ms(plain, inner=100, queued=True),
                        library_ms=None, bound=bound)
            # B3 check window, both forms, with and without the theta
            # schedule: the two-matrix form on K and a contiguous K^T, the
            # transpose form on K alone
            w = _window_inputs(g, m, n, dt)
            forms = (("fused_dense_steps", w),
                     ("fused_dense_steps_kt", dict(w, K_adj=None)))
            for name, wf in forms:
                for gamma in (0.0, 0.05):
                    outs = mk.fused_dense_steps(**wf, n_steps=steps,
                                                gamma=gamma)
                    refs = mk.fused_dense_steps_plain(**w, n_steps=steps,
                                                      gamma=gamma)
                    torch.cuda.synchronize()
                    err, rel = max_err(outs, refs)
                    rows.setdefault(name, []).append(dict(
                        dtype=dname, shape=[m, n], steps=steps, gamma=gamma,
                        max_abs_err=err, rel_err=rel))
                    check(rel <= TOLS[(name, dname)],
                          f"{name} {dname} {tag} gamma={gamma}: "
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

                # reads K (and K_adj), b, Sigma, y, c, lb, ub, T, x, x_bar,
                # tau, sigma (x_prev is overwritten unread); writes x,
                # x_prev, x_bar, the x sum, y, the y sum, tau, sigma
                vecs = (3 * m + 6 * n + 2) + (4 * n + 2 * m + 2)
                ops = steps * (4 * m * n + 4 * m + 9 * n)
                yard, gemv = cuda_ms(stepped), cuda_ms(gemvs)
                # the stepped window of the loop: its schedule and step
                # pair a step around the GEMVs, every launch from the host
                # and as one CUDA graph; both give the same bits
                xs0, ys0 = torch.zeros_like(w["x"]), torch.zeros_like(w["y"])
                wins = {cap: engine.SteppedWindow(
                    op, engine.CUDA_UPDATES, *vec_args, 0.05, steps, w["x"],
                    w["y"], capture=cap) for cap in (False, True)}
                runs = {}
                for cap, win in wins.items():
                    for _ in range(3):       # eager, captured, replayed
                        s1, xs1, ys1 = win.run(state0, xs0, ys0)
                    runs[cap] = [t.clone() for t in (*s1, xs1, ys1)]
                check(all(torch.equal(a, b)
                          for a, b in zip(runs[False], runs[True])),
                      f"stepped window {dname}: the graph's replay differs "
                      f"from the eager window")
                window_ms = {cap: cuda_ms(partial(win.run, state0, xs0, ys0))
                             for cap, win in wins.items()}
                rows["dual_step"][-1].update(
                    window_eager_ms=window_ms[False],
                    window_graph_ms=window_ms[True],
                    window_pdhg_step_ms=yard, window_gemv_ms=gemv)
                times = {}
                # in turns, to share the card's state: two, kt, kt, two
                for name, wf in forms + forms[::-1]:
                    times.setdefault(name, []).append(cuda_ms(
                        lambda: mk.fused_dense_steps(**wf, n_steps=steps,
                                                     gamma=0.05)))
                for name, wf in forms:
                    k_bytes = (2 if wf["K_adj"] is not None else 1) * m * n
                    rows[name][-1].update(
                        ms=statistics.median(times[name]),
                        ms_runs=times[name],
                        plain_ms=cuda_ms(lambda: mk.fused_dense_steps_plain(
                            **wf, n_steps=steps, gamma=0.05)),
                        library_ms=None, yardstick_ms=yard, gemv_ms=gemv,
                        reread_floor_ms=1e3 * steps * k_bytes * size
                        / HBM_BYTES_PER_S,
                        bound=bound_ms((k_bytes + vecs) * size, ops, dname))
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
                  + (f" window_eager_ms={r['window_eager_ms']:.6f}"
                     f" window_graph_ms={r['window_graph_ms']:.6f}"
                     f" window_pdhg_step_ms={r['window_pdhg_step_ms']:.6f}"
                     f" window_gemv_ms={r['window_gemv_ms']:.6f}"
                     if "window_eager_ms" in r else "")
                  + (f" yardstick_ms={r['yardstick_ms']:.6f}"
                     f" gemv_ms={r['gemv_ms']:.6f}"
                     f" reread_floor_ms={r['reread_floor_ms']:.6f}"
                     f" ms_runs={r['ms_runs']}"
                     if "yardstick_ms" in r else ""), flush=True)
    return rows


def phase_dense_forms(steps: int):
    """Both forms of B3 against the plain version beyond the main and
    ragged shapes: a batch of 3, the small CLI stream's lanes, more lanes
    than SMs, rows too long for the transpose form's ring (8192 in f64,
    16384 in f32), each batch also with half its lanes masked off; the
    caller's tensors unchanged and one launch each."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels import pdhg_megakernel as mk

    g = torch.Generator(device="cuda").manual_seed(77)
    rows = {"fused_dense_steps": [], "fused_dense_steps_kt": []}
    cases = (("batch3", 3, 133, 217), ("tiny", 5, 8, 14),
             ("many", 200, 10, 18), ("wide", 1, 64, 20000))
    for dt in (torch.float64, torch.float32):
        dname = str(dt).split(".")[1]
        for tag, B, m, n in cases:
            w = _window_inputs(g, B * m, n, dt)
            w = {k: (v.view(B, m, n) if k == "K" else v)
                 for k, v in w.items()}
            w["K_adj"] = w["K"].transpose(1, 2).contiguous()
            for k, d in (("b", m), ("Sigma", m), ("y", m), ("c", n),
                         ("lb", n), ("ub", n), ("T", n), ("x", n),
                         ("x_prev", n), ("x_bar", n)):
                src = w[k]
                w[k] = (src.view(B, d) if src.numel() == B * d
                        else torch.stack([src] * B))
            w["tau"] = torch.linspace(0.2, 0.3, B, dtype=dt, device="cuda")
            w["sigma"] = torch.full((B,), 0.3, dtype=dt, device="cuda")
            before = {k: v.clone() for k, v in w.items()}
            half = torch.arange(B, device="cuda") % 2 == 0
            for live in (("all", "half") if B > 1 else ("all",)):
                act = half if live == "half" else None
                for name, K_adj in (("fused_dense_steps", w["K_adj"]),
                                    ("fused_dense_steps_kt", None)):
                    kernels.reset_launch_counts()
                    outs = mk.fused_dense_steps(
                        **dict(w, K_adj=K_adj), n_steps=steps, gamma=0.05,
                        active=act)
                    refs = mk.fused_dense_steps_plain(
                        **w, n_steps=steps, gamma=0.05, active=act)
                    torch.cuda.synchronize()
                    counts = kernels.launch_counts()
                    err, rel = max_err(outs, refs)
                    rows[name].append(dict(
                        dtype=dname, shape=[B, m, n], tag=tag, lanes=live,
                        max_abs_err=err, rel_err=rel))
                    check(rel <= TOLS[(name, dname)],
                          f"{name} {dname} {tag} lanes={live}: rel err "
                          f"{rel:.3e}")
                    check(counts[name] == 1 and sum(counts.values()) == 1,
                          f"{name} {tag}: launches {counts}")
                    check(all(torch.equal(w[k], before[k]) for k in w),
                          f"{name} {tag}: the caller's tensors changed")
                    if act is not None:
                        check(all(torch.equal(o[~act], w[k][~act])
                                  for o, k in zip(outs[:4], (
                                      "x", "x_prev", "x_bar", "y")))
                              and not outs[6][~act].any()
                              and not outs[7][~act].any(),
                              f"{name} {dname} {tag}: a masked lane moved")
            del w, before
    for name, checks in rows.items():
        for r in checks:
            print(f"kernel {name} " + " ".join(
                f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in r.items()), flush=True)
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
    import torch

    before = torch.cuda.memory_allocated()
    res, wall, peak = _timed(fn)
    print(f"main {label}: status={res.status} iterations={res.iterations} "
          f"merit={res.merit:.3e} wall_s={wall:.3f} "
          f"max_memory_allocated={peak} retained_bytes="
          f"{torch.cuda.memory_allocated() - before}", flush=True)
    return res, wall


def _counted(fn):
    """Run ``fn`` with every launch count (and the CUDA-graph counts of
    ``engine.GRAPHS``) set to 0 just before it; return its result and
    the launch counts read just after."""
    from repro_torch import kernels
    from repro_torch.core import engine

    kernels.reset_launch_counts()
    engine.GRAPHS.update(captures=0, replays=0)
    out = fn()
    return out, kernels.launch_counts()


def stepped_launches(iterations: int, **more) -> dict:
    """The launches of a stepped solve of ``iterations`` steps in windows
    of ``CHECK_EVERY``: B1's and B2's step forms every step and the
    schedule every window."""
    return launches(dual_step=iterations, primal_step=iterations,
                    schedule=iterations // CHECK_EVERY, **more)


@contextlib.contextmanager
def eager_windows():
    """Every stepped window inside runs eagerly: the entry points reach
    ``engine.pdhg_loop`` through ``engine.solve_core``, whose ``graph``
    switch this sets to False.  Each launch is then counted where it
    launches, not added by a replay."""
    from repro_torch.core import engine

    core = engine.solve_core
    engine.solve_core = partial(core, graph=False)
    try:
        yield
    finally:
        engine.solve_core = core


def graphs() -> dict:
    from repro_torch.core import engine

    return dict(engine.GRAPHS)


def phase_main(instance: str):
    """The port's main path through its entry points; returns each
    path's own launch counts."""
    import numpy as np

    from repro_torch.core import engine
    from repro_torch.core.pdhg import PDHGOptions, solve_jit
    from repro_torch.launch import solve as cli

    # the CLI default: gen-ip002, stepped, CUDA update kernels, a CUDA
    # graph a window
    (res0, _), cli_counts = _counted(lambda: _run(
        "cli gen-ip002", lambda: cli.main(["--instance", "gen-ip002"])))
    lp0 = cli.load_instance("gen-ip002")
    rel0 = abs(res0.obj - lp0.obj_opt) / abs(lp0.obj_opt)
    print(f"main cli gen-ip002: launches={cli_counts} graphs={graphs()}",
          flush=True)
    check(res0.status == "optimal" and rel0 <= 1e-4,
          f"gen-ip002: {res0.status}, rel err {rel0:.3e}")
    want0 = stepped_launches(res0.iterations)
    check(cli_counts == want0,
          f"gen-ip002 launches {cli_counts}, expected {want0}")
    counts = {"cli gen-ip002": cli_counts}

    t0 = time.perf_counter()
    lp = cli.load_instance(instance)
    print(f"main {instance}: generated in {time.perf_counter() - t0:.3f}s",
          flush=True)
    opts = PDHGOptions(max_iters=MAX_ITERS, tol=TOL,
                       check_every=CHECK_EVERY)
    mega = dataclasses.replace(opts, megakernel=True)
    results = {}
    # stepped as a CUDA graph a window (the default), stepped with every
    # window eager (the comparison's switch), megakernel
    for label, o, ctx in (("stepped", opts, contextlib.nullcontext),
                          ("stepped eager", opts, eager_windows),
                          ("megakernel", mega, contextlib.nullcontext)):
        with ctx():
            (res, wall), delta = _counted(lambda: _run(
                f"{instance} {label}", lambda: solve_jit(lp, o)))
        g = graphs()
        rel = abs(res.obj - lp.obj_opt) / abs(lp.obj_opt)
        print(f"main {instance} {label}: objective={res.obj:.9f} "
              f"known={lp.obj_opt:.9f} rel_err={rel:.3e} "
              f"mvm_calls={res.mvm_calls} launches={delta} graphs={g}",
              flush=True)
        check(res.status == "optimal" and rel <= 1e-4,
              f"{instance} {label}: {res.status}, rel err {rel:.3e}")
        check(res.mvm_calls == engine.mvm_accounting(
            res.iterations, CHECK_EVERY, opts.lanczos_iters, restart=True),
            f"{instance} {label}: mvm_calls {res.mvm_calls}")
        windows = res.iterations // CHECK_EVERY
        # the megakernel solve builds its adjoint as K's transpose: B3's
        # transpose form once a window, its two-matrix form never
        want = (launches(fused_dense_steps_kt=windows)
                if label == "megakernel" else
                stepped_launches(res.iterations))
        check(delta == want, f"{instance} {label}: launches {delta}, "
                             f"expected {want}")
        # the first window runs eagerly, the second is captured, and
        # every window from it on is a replay
        want_g = ({"captures": 1, "replays": windows - 1}
                  if label == "stepped" else {"captures": 0, "replays": 0})
        check(g == want_g, f"{instance} {label}: graphs {g}, expected "
                           f"{want_g}")
        results[label] = (res, wall)
        counts[label] = delta
    (ra, _), (re, _), (rb, _) = (results["stepped"],
                                 results["stepped eager"],
                                 results["megakernel"])
    check(ra.iterations == re.iterations and np.array_equal(ra.x, re.x)
          and np.array_equal(ra.y, re.y),
          f"graph and eager stepped solves differ: {ra.iterations} vs "
          f"{re.iterations} iterations, max|dx|="
          f"{float(abs(ra.x - re.x).max()):.3e}")
    dx = float(abs(ra.x - rb.x).max())
    print(f"main {instance}: stepped graph vs eager x bit-identical, "
          f"stepped vs megakernel max|dx|={dx:.3e}", flush=True)
    check(ra.iterations == rb.iterations,
          f"iterations differ: {ra.iterations} vs {rb.iterations}")
    check(dx <= 1e-8, f"x differs by {dx:.3e}")
    return counts, ra


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
    # conductances, the step pair every step (eager: read noise) and no
    # B6
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
        want = stepped_launches(res.iterations)
        check(delta == want, f"{label}: launches {delta}, expected {want}")
        check(graphs()["captures"] == 0,
              f"{label}: a noisy window was captured")
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
        want = launches(dual_update=res.iterations,
                        primal_update=res.iterations,
                        crossbar_mvm=res.mvm_calls if use_kernel else 0)
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
    check(delta == stepped_launches(r.iterations)
          and graphs()["captures"] == 0, f"jit full: launches {delta}, "
                                         f"graphs {graphs()}")
    counts["jit full"] = delta
    # (d) the same on a noiseless device, stepped and with the megakernel:
    # the decoded blocks K_fwd and K_adj are distinct cells, so B3 runs
    # its two-matrix form every window; both runs must agree
    noiseless = dataclasses.replace(TAOX_HFOX, sigma_read=0.0)
    twins = {}
    for label, mega in (("jit noiseless stepped", False),
                        ("jit noiseless megakernel", True)):
        opts = PDHGOptions(max_iters=JIT_NOISELESS_ITERS,
                           check_every=CHECK_EVERY, megakernel=mega)
        (rep, wall, peak), delta = _counted(lambda: _timed(
            lambda: solve_crossbar_jit(lp, opts, device=noiseless)))
        r, led = rep.result, rep.ledger
        print(f"crossbar {label}: status={r.status} "
              f"iterations={r.iterations} merit={r.merit:.3e} "
              f"mvm_calls={r.mvm_calls} wall_s={wall:.3f} "
              f"max_memory_allocated={peak} launches={delta} "
              f"{_ledger_line(led)}", flush=True)
        # its merit must fall below the host driver's at its first check
        check(led.mvm_count == r.mvm_calls and np.isfinite(r.merit)
              and r.merit < first,
              f"{label}: mvm_count {led.mvm_count}, mvm_calls "
              f"{r.mvm_calls}, merit {r.merit:.3e}")
        want = (launches(fused_dense_steps=r.iterations // CHECK_EVERY)
                if mega else stepped_launches(r.iterations))
        check(delta == want, f"{label}: launches {delta}, expected {want}")
        # noiseless, so the stepped windows run as a CUDA graph
        want_g = {"captures": 0 if mega else 1,
                  "replays": 0 if mega else r.iterations // CHECK_EVERY - 1}
        check(graphs() == want_g, f"{label}: graphs {graphs()}, expected "
                                  f"{want_g}")
        counts[label] = delta
        twins[mega] = (r, led)
    (ra, la), (rb, lb) = twins[False], twins[True]
    dx = float(np.max(np.abs(ra.x - rb.x)))
    print(f"crossbar jit noiseless: stepped vs megakernel max|dx|={dx:.3e}",
          flush=True)
    check(ra.iterations == rb.iterations and ra.status == rb.status,
          f"jit noiseless: stepped {ra.status}/{ra.iterations} vs "
          f"megakernel {rb.status}/{rb.iterations}")
    check(la.mvm_count == lb.mvm_count,
          f"jit noiseless: ledgers {la.mvm_count} vs {lb.mvm_count}")
    check(dx <= 1e-8, f"jit noiseless: x differs by {dx:.3e}")
    return counts


# ------------------------------------------------- the sparse stream ---

def stream_instances(scale: int):
    """The full-width sparse stream at ``scale`` times the reference's
    stream shapes, generated on the host (set-up)."""
    from repro_torch.lp import SPARSE_STREAM_SHAPES, sparse_lp_stream

    shapes = [(scale * m, scale * n) for m, n in SPARSE_STREAM_SHAPES]
    return sparse_lp_stream(STREAM_INSTANCES, shapes,
                            density=STREAM_DENSITY, seed=0)


def stream_options(**kw):
    from repro_torch.core.pdhg import PDHGOptions

    kw = {"max_iters": STREAM_MAX_ITERS, **kw}
    return PDHGOptions(tol=TOL, check_every=CHECK_EVERY, **kw)


def main_bucket(lps):
    """The stream's largest ELL bucket, stacked as the solver stacks it:
    ``(signature, stacked numpy arrays)``."""
    from repro_torch.runtime import BatchSolver
    from repro_torch.runtime.batch import stack_problems_ell

    solver = BatchSolver(stream_options())
    buckets = solver._group_buckets(lps)
    ((mb, nb), sig), idxs = max(buckets.items(), key=lambda kv: len(kv[1]))
    group = [lps[i] for i in idxs]
    B = solver._padded_batch(len(group))
    group += [group[0]] * (B - len(group))
    return ((mb, nb), sig, B), stack_problems_ell(group, m=mb, n=nb,
                                                  wf=sig[1], wa=sig[2])


def _ell_forms(rng, B, m, n, W):
    """B random sparse K (about W entries a row, ||K|| ~ 1) as both ELL
    forms, built from the same COO (numpy)."""
    import numpy as np

    from repro_torch.kernels.sparse_mvm import ell_from_coo

    forms = []
    for _ in range(B):
        K = (rng.normal(size=(m, n)) * (rng.random((m, n)) < W / n)
             / (W ** 0.5))
        r, c = K.nonzero()
        forms.append((ell_from_coo(K[r, c], r, c, (m, n)),
                      ell_from_coo(K[r, c], c, r, (n, m))))
    wf = max(f[0][0].shape[1] for f in forms)
    wa = max(f[1][0].shape[1] for f in forms)

    def pad(a, w):
        return np.pad(a, ((0, 0), (0, w - a.shape[1])))

    return (np.stack([pad(f[0][0], wf) for f in forms]),
            np.stack([pad(f[0][1], wf) for f in forms]),
            np.stack([pad(f[1][0], wa) for f in forms]),
            np.stack([pad(f[1][1], wa) for f in forms]))


def _ell_window(forms, dt, g):
    """A well-posed ELL window on the card from the numpy ``forms``:
    Pock–Chambolle diagonals from the forms' row sums (at most 1, so an
    empty row of a padded lane stays bounded), per-lane steps of 0.9, a
    start inside the bounds."""
    import torch

    df, cf, da, ca = (torch.as_tensor(a, device="cuda") for a in forms)
    df, da = df.to(dt), da.to(dt)
    B, m, n = df.shape[0], df.shape[1], da.shape[1]
    Sigma = 1.0 / torch.clamp(df.abs().sum(-1), min=1.0)
    T = 1.0 / torch.clamp(da.abs().sum(-1), min=1.0)
    lb, ub = _bounds(g, (B, n), dt)
    x = torch.clamp(_vec(g, (B, n), dt), lb, ub)
    return dict(data_f=df, cols_f=cf.int(), data_a=da, cols_a=ca.int(),
                b=_vec(g, (B, m), dt), c=_vec(g, (B, n), dt), lb=lb, ub=ub,
                T=T, Sigma=Sigma, x=x, x_prev=x.clone(), x_bar=x.clone(),
                y=_vec(g, (B, m), dt),
                tau=torch.full((B,), 0.9, dtype=dt, device="cuda"),
                sigma=torch.full((B,), 0.9, dtype=dt, device="cuda"))


def _csr(data, cols, n):
    """The stored entries of a (B, rows, W) ELL form as one block-diagonal
    CSR matrix (B * rows, B * n): cuSPARSE's yardstick."""
    import torch

    Bl, rows, W = data.shape
    csr = torch.sparse_coo_tensor(
        torch.stack([
            torch.arange(Bl * rows, device="cuda").repeat_interleave(W),
            (cols.long() + (torch.arange(Bl, device="cuda") * n)
             .view(-1, 1, 1)).reshape(-1)]),
        data.reshape(-1), (Bl * rows, Bl * n),
        check_invariants=False).coalesce()
    keep = csr.values() != 0
    return torch.sparse_coo_tensor(
        csr.indices()[:, keep], csr.values()[keep], csr.shape,
        check_invariants=False).coalesce().to_sparse_csr()


def kernel_attrs_lines():
    """B4's and B5's registers, local bytes and resident blocks an SM, in
    f64 and f32, 16-byte-load and scalar forms, and B3's transpose
    form's, with its dynamic shared memory and variant, at the ragged,
    main and wide row lengths."""
    import torch

    from repro_torch.kernels import _build

    out = {}
    for dt in (torch.float64, torch.float32):
        dname = str(dt).split(".")[1]
        for n in (1235, 7680, 20000):
            a = _build.dense_t_attrs(dt, n)
            print(f"kernel attrs fused_dense_steps_kt {dname} n={n}: "
                  + " ".join(f"{k}={v}" for k, v in a.items()), flush=True)
            out.setdefault("fused_dense_steps_kt", {})[
                f"{dname} n={n}"] = a
    for name, key in (("ell_matvec", "ell_matvec"),
                      ("pdhg_fused_ell", "fused_ell_steps")):
        for dt in (torch.float64, torch.float32):
            for vec in (True, False):
                a = _build.kernel_attrs(name, dt, vec)
                form = "vector" if vec else "scalar"
                dname = str(dt).split(".")[1]
                print(f"kernel attrs {key} {dname} {form}: "
                      f"registers={a['registers']} "
                      f"local_bytes={a['local_bytes']} "
                      f"blocks_per_sm={a['blocks_per_sm']}", flush=True)
                out.setdefault(key, {})[f"{dname} {form}"] = a
    return out


def phase_ell_kernels(bucket, steps: int):
    """B4 and B5 against their plain versions (ragged, a batch of 3 also
    with a strided v, width 0, the NaN contract with v[0] = inf and the
    main bucket; each with and without row lengths, B5 also with half its
    lanes masked off), and B1-B3 batched; times at the main bucket go
    into the JSON line."""
    import numpy as np
    import torch

    from repro_torch.core import engine
    from repro_torch.kernels import pdhg_megakernel as mk
    from repro_torch.kernels import pdhg_update as upd
    from repro_torch.kernels import sparse_mvm as sm

    (mb, nb), sig, B = bucket[0]
    rng = np.random.default_rng(99)
    g = torch.Generator(device="cuda").manual_seed(99)
    rows = {"ell_matvec": [], "fused_ell_steps": [], "batched": []}
    cases = (("ragged", _ell_forms(rng, 1, 777, 1235, 13)),
             ("batch3", _ell_forms(rng, 3, 300, 517, 7)),
             ("width0", tuple(np.zeros((2, d, 0), t) for d, t in
                              ((6, np.float64), (6, np.int32),
                               (10, np.float64), (10, np.int32)))),
             ("main", tuple(bucket[1][:4])))
    for dt in (torch.float64, torch.float32):
        dname = str(dt).split(".")[1]
        size = torch.finfo(dt).bits // 8
        tol = TOLS[("ell_matvec", dname)]
        for tag, forms in cases:
            w = _ell_window(forms, dt, g)
            if tag == "ragged":         # no batch axis
                w = {k: v[0] for k, v in w.items()}
            df, cf, da, ca = (w[k] for k in ("data_f", "cols_f", "data_a",
                                             "cols_a"))
            rl = dict(row_len_f=sm.ell_row_len(df, cf),
                      row_len_a=sm.ell_row_len(da, ca))
            Bl = df.shape[0] if df.dim() == 3 else 1
            (m, W), (n, Wa) = df.shape[-2:], da.shape[-2:]
            # B4, forward and adjoint, every slot and with row lengths
            for with_len in (False, True):
                rf, ra = ((rl["row_len_f"], rl["row_len_a"]) if with_len
                          else (None, None))
                outs = [sm.ell_matvec(df, cf, w["x"], rf),
                        sm.ell_matvec(da, ca, w["y"], ra)]
                refs = [sm.ell_matvec_plain(df, cf, w["x"], rf),
                        sm.ell_matvec_plain(da, ca, w["y"], ra)]
                if tag == "batch3":     # a strided v: a slice of a longer one
                    wide = torch.cat([w["x"], w["x"][:, :5]], dim=1)
                    outs.append(sm.ell_matvec(df, cf, wide[:, 5:], rf))
                    refs.append(sm.ell_matvec_plain(
                        df, cf, wide[:, 5:].contiguous(), rf))
                torch.cuda.synchronize()
                if W == 0:
                    err, rel = max(float(o.abs().max()) for o in outs), 0.0
                    check(err == 0.0, f"ell_matvec {dname} width 0: {err}")
                else:
                    err, rel = max_err(outs, refs)
                row = dict(dtype=dname, shape=[Bl, m, W], tag=tag,
                           row_len=with_len, max_abs_err=err, rel_err=rel)
                rows["ell_matvec"].append(row)
                check(rel <= tol, f"ell_matvec {dname} {tag} row_len="
                                  f"{with_len}: rel err {rel:.3e}")
                if tag == "ragged":
                    # the NaN contract: v[0] = inf turns the padded rows,
                    # and only them, to NaN, as in the plain version
                    v = w["x"].clone()
                    v[0] = float("inf")
                    out = sm.ell_matvec(df, cf, v, rf)
                    ref = sm.ell_matvec_plain(df, cf, v, rf)
                    nan, fin = torch.isnan(ref), torch.isfinite(ref)
                    err, rel = max_err([out[fin]], [ref[fin]])
                    rows["ell_matvec"].append(dict(
                        dtype=dname, shape=[Bl, m, W], tag="nan",
                        row_len=with_len, max_abs_err=err, rel_err=rel))
                    # rows with an entry in column 0 and no padding are
                    # +-inf on both sides
                    check(torch.equal(torch.isnan(out), nan)
                          and torch.equal(out[~fin & ~nan],
                                          ref[~fin & ~nan])
                          and bool(nan.any()) and rel <= tol,
                          f"ell_matvec {dname} NaN contract row_len="
                          f"{with_len}: rel err {rel:.3e}")
            if tag == "main":
                row = rows["ell_matvec"][-1]        # with row lengths
                nnz_f, nnz_a = int((df != 0).sum()), int((da != 0).sum())
                csr_f, csr_a = _csr(df, cf, n), _csr(da, ca, m)
                xv, yv = w["x"].reshape(-1, 1), w["y"].reshape(-1, 1)
                for csr, vec, ref, what in (
                        (csr_f, xv, refs[0], "forward"),
                        (csr_a, yv, refs[1], "adjoint")):
                    lib = (csr @ vec).view(ref.shape)
                    check(max_err([lib], [ref])[1] <= tol,
                          f"ell_matvec {dname}: cuSPARSE {what} disagrees")
                rf, ra = rl["row_len_f"], rl["row_len_a"]
                # the same entries with every column at its own row's
                # index mod n: the gathers of v then hit in cache
                local = (torch.arange(m, device="cuda", dtype=torch.int32)
                         % n).view(1, m, 1).expand_as(cf).contiguous()
                # with row lengths: reads the stored entries, the row
                # lengths and v once, writes w
                row.update(
                    local_gather_ms=cuda_ms(lambda: sm.ell_matvec(
                        df, local, w["x"], rf), reps=20, inner=10),
                    ms=cuda_ms(lambda: sm.ell_matvec(df, cf, w["x"], rf),
                               reps=20, inner=10),
                    all_slots_ms=cuda_ms(lambda: sm.ell_matvec(
                        df, cf, w["x"]), reps=20, inner=10),
                    adjoint_ms=cuda_ms(lambda: sm.ell_matvec(
                        da, ca, w["y"], ra), reps=20, inner=10),
                    adjoint_all_slots_ms=cuda_ms(lambda: sm.ell_matvec(
                        da, ca, w["y"]), reps=20, inner=10),
                    plain_ms=cuda_ms(lambda: sm.ell_matvec_plain(
                        df, cf, w["x"], rf), reps=5, inner=2),
                    library_ms=cuda_ms(lambda: csr_f @ xv, reps=20,
                                       inner=10),
                    adjoint_library_ms=cuda_ms(lambda: csr_a @ yv, reps=20,
                                               inner=10),
                    nnz=nnz_f, adjoint_nnz=nnz_a,
                    nnz_bound_ms=bound_ms(nnz_f * (size + 4), 2 * nnz_f,
                                          dname)[0],
                    adjoint_nnz_bound_ms=bound_ms(nnz_a * (size + 4),
                                                  2 * nnz_a, dname)[0],
                    all_slots_bound_ms=bound_ms(
                        Bl * m * W * (size + 4) + Bl * (n + m) * size,
                        2 * Bl * m * W, dname)[0],
                    bound=bound_ms(nnz_f * (size + 4) + Bl * m * 4
                                   + Bl * (n + m) * size, 2 * nnz_f, dname))
                del csr_f, csr_a, local
            # B5, with and without the theta schedule: every slot and
            # every lane as before, then with row lengths, all lanes live
            # and half of them masked off
            half = torch.arange(Bl, device="cuda") % 2 == 0
            for gamma in (0.0, 0.05):
                for live, kw in (("all", {}), ("all", rl),
                                 ("half", dict(rl, active=half))):
                    if live == "half" and Bl == 1:
                        continue
                    outs = mk.fused_ell_steps(**w, **kw, n_steps=steps,
                                              gamma=gamma)
                    refs = mk.fused_ell_steps_plain(**w, **kw,
                                                    n_steps=steps,
                                                    gamma=gamma)
                    torch.cuda.synchronize()
                    err, rel = max_err(outs, refs)
                    rows["fused_ell_steps"].append(dict(
                        dtype=dname, shape=[Bl, m, n, W, Wa], tag=tag,
                        steps=steps, gamma=gamma, row_len=bool(kw),
                        lanes=live, max_abs_err=err, rel_err=rel))
                    check(rel <= TOLS[("fused_ell_steps", dname)],
                          f"fused_ell_steps {dname} {tag} gamma={gamma} "
                          f"row_len={bool(kw)} lanes={live}: rel err "
                          f"{rel:.3e}")
                    if live == "half":
                        check(all(torch.equal(o[~half], w[k][~half])
                                  for o, k in zip(outs[:4], ("x", "x_prev",
                                                             "x_bar", "y")))
                              and not outs[6][~half].any(),
                              f"fused_ell_steps {dname} {tag}: a masked "
                              f"lane moved")
            if tag == "main":
                op = engine.sparse_ell_operator(df, cf, da, ca, **rl)
                state0 = engine.PDHGState(w["x"], w["x_prev"], w["x_bar"],
                                          w["y"], w["tau"], w["sigma"])
                vec_args = (w["b"], w["c"], w["lb"], w["ub"], w["T"],
                            w["Sigma"])

                def stepped():
                    # yardstick: the stepped ELL window, B4 + B1 + B4 + B2,
                    # B4 with row lengths as the solve calls it
                    s, xs, ys = state0, 0.0, 0.0
                    for _ in range(steps):
                        s = engine.pdhg_step(op, engine.CUDA_UPDATES,
                                             *vec_args, 0.0, s)
                        xs, ys = xs + s.x, ys + s.y
                    return s, xs, ys

                nnz = int((df != 0).sum() + (da != 0).sum())
                entry_bytes = nnz * (size + 4) + Bl * (m + n) * 4
                # reads both forms' stored entries and row lengths, b,
                # Sigma, y, c, lb, ub, T, x, x_bar, tau, sigma once;
                # writes x, x_prev, x_bar, the x sum, y, the y sum, tau,
                # sigma
                vecs = Bl * ((3 * m + 6 * n + 2) + (4 * n + 2 * m + 2))
                live = torch.ones(Bl, dtype=torch.bool, device="cuda")
                rows["fused_ell_steps"][-2].update(
                    ms=cuda_ms(lambda: mk.fused_ell_steps(
                        **w, **rl, active=live, n_steps=steps, gamma=0.05),
                        reps=10),
                    all_slots_ms=cuda_ms(lambda: mk.fused_ell_steps(
                        **w, n_steps=steps, gamma=0.05), reps=10),
                    half_masked_ms=cuda_ms(lambda: mk.fused_ell_steps(
                        **w, **rl, active=half, n_steps=steps, gamma=0.05),
                        reps=10),
                    plain_ms=cuda_ms(lambda: mk.fused_ell_steps_plain(
                        **w, **rl, n_steps=steps, gamma=0.05), reps=3,
                        warmup=1),
                    library_ms=None,
                    yardstick_ms=cuda_ms(stepped, reps=5, warmup=1),
                    reread_floor_ms=1e3 * steps * entry_bytes
                    / HBM_BYTES_PER_S,
                    all_slots_reread_floor_ms=1e3 * steps * Bl
                    * (m * W + n * Wa) * (size + 4) / HBM_BYTES_PER_S,
                    bound=bound_ms(
                        entry_bytes + vecs * size,
                        steps * (4 * nnz + Bl * (4 * m + 9 * n)), dname))
            del w
        # B1-B3 with a batch axis against their plain versions
        lanes = torch.arange(1, B + 1, dtype=dt, device="cuda")
        y, kx, b, S = (_vec(g, (B, mb), dt) for _ in range(4))
        sigma = 0.1 * lanes
        out = upd.dual_update(y, kx, b, S, sigma)
        err, rel = max_err([out], [upd.dual_update_plain(y, kx, b, S,
                                                         sigma)])
        rows["batched"].append(dict(kernel="dual_update", dtype=dname,
                                    shape=[B, mb], max_abs_err=err,
                                    rel_err=rel))
        check(rel <= TOLS[("dual_update", dname)],
              f"batched dual_update {dname}: rel err {rel:.3e}")
        x, kty, c = (_vec(g, (B, nb), dt) for _ in range(3))
        T = _vec(g, (B, nb), dt, 0.5, 1.0)
        lb, ub = _bounds(g, (B, nb), dt)
        tau, theta = 0.05 * lanes, 1.0 / lanes
        outs = upd.primal_update(x, kty, c, T, lb, ub, tau, theta)
        err, rel = max_err(outs, upd.primal_update_plain(
            x, kty, c, T, lb, ub, tau, theta))
        rows["batched"].append(dict(kernel="primal_update", dtype=dname,
                                    shape=[B, nb], max_abs_err=err,
                                    rel_err=rel))
        check(rel <= TOLS[("primal_update", dname)],
              f"batched primal_update {dname}: rel err {rel:.3e}")
        wd = _window_inputs(g, 4 * 1024, 2048, dt)
        wd = {k: (v.view(4, 1024, 2048) if k == "K" else v)
              for k, v in wd.items()}
        bw = dict(K=wd["K"], K_adj=wd["K"].transpose(1, 2).contiguous(),
                  tau=torch.full((4,), 0.3, dtype=dt, device="cuda"),
                  sigma=torch.full((4,), 0.3, dtype=dt, device="cuda"))
        for k, d in (("b", 1024), ("Sigma", 1024), ("y", 1024),
                     ("c", 2048), ("lb", 2048), ("ub", 2048), ("T", 2048),
                     ("x", 2048), ("x_prev", 2048), ("x_bar", 2048)):
            src = wd[k]
            bw[k] = (src.view(4, d) if src.numel() == 4 * d
                     else torch.stack([src] * 4))
        refs = mk.fused_dense_steps_plain(**bw, n_steps=steps, gamma=0.05)
        for name, K_adj in (("fused_dense_steps", bw["K_adj"]),
                            ("fused_dense_steps_kt", None)):
            outs = mk.fused_dense_steps(**dict(bw, K_adj=K_adj),
                                        n_steps=steps, gamma=0.05)
            torch.cuda.synchronize()
            err, rel = max_err(outs, refs)
            rows["batched"].append(dict(kernel=name, dtype=dname,
                                        shape=[4, 1024, 2048],
                                        max_abs_err=err, rel_err=rel))
            check(rel <= TOLS[(name, dname)],
                  f"batched {name} {dname}: rel err {rel:.3e}")
    for name in ("ell_matvec", "fused_ell_steps"):
        for r in rows[name]:
            print(f"kernel {name} " + " ".join(
                f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in r.items()), flush=True)
    for r in rows["batched"]:
        print(f"kernel batched {r['kernel']} {r['dtype']} shape={r['shape']}"
              f" max_abs_err={r['max_abs_err']:.3e}"
              f" rel_err={r['rel_err']:.3e}", flush=True)
    return rows


def phase_small_streams():
    """The reference's small batch streams through the port's CLI; each
    path's launch counts are read on their own."""
    import numpy as np

    from repro_torch.launch import solve as cli

    counts = {}

    def run(label, args):
        (out, wall, peak), delta = _counted(lambda: _timed(
            lambda: cli.main(["--backend", "batch", *args])))
        print(f"stream {label}: wall_s={wall:.3f} max_memory_allocated="
              f"{peak} launches={delta}", flush=True)
        counts[label] = delta
        return out, delta

    specs = SMALL_DENSE.split(",")
    lps = [cli.load_instance(s, seed=i) for i, s in enumerate(specs)]

    def exact(label, out):
        for lp, r in zip(lps, out):
            rel = abs(r.obj - lp.obj_opt) / abs(lp.obj_opt)
            check(r.status == "optimal" and rel <= 1e-4,
                  f"{label} {lp.name}: {r.status}, rel err {rel:.3e}")

    out, d = run("small dense", ["--instances", SMALL_DENSE])
    exact("small dense", out)
    check(d["dual_step"] == d["primal_step"] > 0
          and d["dual_step"] == CHECK_EVERY * d["schedule"]
          and d["dual_update"] == d["primal_update"] == 0
          and d["fused_dense_steps"] == d["ell_matvec"] == 0
          and d["fused_dense_steps_kt"] == 0,
          f"small dense: launches {d}")
    check(graphs()["captures"] > 0, f"small dense: graphs {graphs()}")
    # the same stream with every window eager: the same launches, each
    # counted where it launches, and the same bits
    with eager_windows():
        out_e, d_e = run("small dense eager", ["--instances", SMALL_DENSE])
    check(graphs() == {"captures": 0, "replays": 0},
          f"small dense eager: graphs {graphs()}")
    check(d_e == d, f"small dense: launches {d} as a graph, {d_e} eager")
    check([r.iterations for r in out_e] == [r.iterations for r in out]
          and all(np.array_equal(a.x, b.x) for a, b in zip(out_e, out)),
          "small dense: graph and eager solves differ")
    out, d = run("small dense megakernel",
                 ["--instances", SMALL_DENSE, "--megakernel"])
    exact("small dense megakernel", out)
    check(d["fused_dense_steps_kt"] > 0 and d["fused_dense_steps"] == 0
          and d["dual_update"] == d["dual_step"] == d["schedule"] == 0,
          f"small dense megakernel: launches {d}")
    sp_specs = SMALL_SPARSE.split(",")
    sp_lps = [cli.load_instance(s, seed=i) for i, s in enumerate(sp_specs)]
    # at tol=1e-6 sprand:128x256:0.02 stops at iteration_limit within
    # 40000 iterations in the reference too; tol=1e-4 is the reference's
    # own recipe for this stream
    out, d = run("small sparse", ["--sparse", "--instances", SMALL_SPARSE,
                                  "--tol", "1e-4"])
    for lp, r in zip(sp_lps, out):
        rel = abs(r.obj - lp.obj_opt) / abs(lp.obj_opt)
        check(r.status == "optimal" and rel <= 1e-4,
              f"small sparse {lp.name}: {r.status}, rel err {rel:.3e}")
    check(d["ell_matvec"] > 0 and d["dual_step"] > 0
          and d["dual_step"] == CHECK_EVERY * d["schedule"]
          and d["fused_ell_steps"] == d["dual_update"] == 0,
          f"small sparse: launches {d}")
    # with two refinement rounds: without them rand:10x18's read-noise
    # floor straddles the 5e-2 band (3e-2 to 7e-2 over eight seeds on the
    # CPU, 4.6e-2 in the reference; PERF.md), and the refined batched path
    # is the one that reads B6 most
    out, d = run("small taox", ["--device", "taox", "--kernel", "cuda",
                                "--instances", SMALL_DENSE, "--max-iters",
                                str(SMALL_STREAM_CROSSBAR_ITERS),
                                "--refine-rounds", "2"])
    for lp, rep in zip(lps, out):
        rel = abs(rep.result.obj - lp.obj_opt) / abs(lp.obj_opt)
        print(f"stream small taox {lp.name}: objective="
              f"{rep.result.obj:.9f} known={lp.obj_opt:.9f} rel_err="
              f"{rel:.3e} executed_iterations={rep.executed_iterations}",
              flush=True)
        check(rel <= OBJ_BAND, f"small taox {lp.name}: rel err {rel:.3e} "
                               f"outside {OBJ_BAND}")
    check(d["crossbar_mvm"] > 0 and d["dual_step"] > 0
          and d["dual_update"] == 0, f"small taox: launches {d}")
    return counts


def _stream_run(label, solver, lps):
    """One counted pass of the stream; returns (results, launches,
    stats, wall)."""
    (res, wall, peak), delta = _counted(lambda: _timed(
        lambda: solver.solve_stream(lps)))
    st = solver.last_stream_stats
    windows = [(b["bucket"][1], b["lanes"], b["windows"])
               for b in st["bucket_windows"]]
    print(f"stream {label}: wall_s={wall:.3f} max_memory_allocated={peak} "
          f"compiles={st['compiles']} windows={windows} launches={delta} "
          f"graphs={graphs()}", flush=True)
    print(f"stream {label}: stream: buckets={st['n_buckets']} "
          f"dispatch={st['dispatch_s']:.3f}s "
          f"collect={st['collect_s']:.3f}s "
          f"host_stack_bytes=dense:{st['dense_stack_bytes']}"
          f"/sparse:{st['sparse_stack_bytes']}", flush=True)
    return res, delta, st, wall


def phase_stream(lps, probe: bool = False):
    """The full-width sparse stream through ``BatchSolver``, stepped and
    with the megakernel, then a warm stepped pass (``probe``: the stepped
    pass alone, within the CLI's iteration budget)."""
    import numpy as np

    from repro_torch.runtime import BatchSolver

    opts = stream_options(max_iters=MAX_ITERS) if probe else stream_options()
    nnz = [lp.K.nnz for lp in lps]
    print(f"stream: {len(lps)} instances, shapes "
          f"{sorted({lp.K.shape for lp in lps})}, nnz {min(nnz)}..."
          f"{max(nnz)}", flush=True)
    counts, results = {}, {}
    for label, o, ctx in (
            ("stream stepped", opts, contextlib.nullcontext),
            ("stream stepped eager", opts, eager_windows),
            ("stream megakernel", dataclasses.replace(opts, megakernel=True),
             contextlib.nullcontext)):
        solver = BatchSolver(o)
        with ctx():
            res, delta, st, wall = _stream_run(label, solver, lps)
        rels = [abs(r.obj - lp.obj_opt) / abs(lp.obj_opt)
                for r, lp in zip(res, lps)]
        print(f"{label}: iterations={[r.iterations for r in res]} "
              f"status={[r.status for r in res]} "
              f"max_merit={max(r.merit for r in res):.3e} "
              f"max_rel_err={max(rels):.3e}", flush=True)
        if probe:
            return res
        for r, lp, rel in zip(res, lps, rels):
            check(r.status == "optimal" and rel <= 1e-4,
                  f"{label} {lp.name}: {r.status}, rel err {rel:.3e}")
        check(st["dense_stack_bytes"] == 0,
              f"{label}: dense stack {st['dense_stack_bytes']} bytes")
        w = sum(b["windows"] for b in st["bucket_windows"])
        n_b = len(st["bucket_windows"])
        lanczos = 2 * opts.lanczos_iters * n_b
        want = (stepped_launches(
                    w * CHECK_EVERY,
                    ell_matvec=lanczos + w * (2 * CHECK_EVERY + 4))
                if label.startswith("stream stepped") else
                launches(ell_matvec=lanczos + 4 * w, fused_ell_steps=w))
        check(delta == want, f"{label}: launches {delta}, expected {want}")
        # each bucket's stepped loop: a capture on the bucket's stream
        # at its second window, a replay every window from it on
        want_g = ({"captures": n_b, "replays": w - n_b}
                  if label == "stream stepped" else
                  {"captures": 0, "replays": 0})
        check(graphs() == want_g, f"{label}: graphs {graphs()}, expected "
                                  f"{want_g}")
        counts[label] = delta
        results[label] = (res, solver)
    (ra, solver), (re, _), (rb, _) = (results["stream stepped"],
                                      results["stream stepped eager"],
                                      results["stream megakernel"])
    check([a.iterations for a in ra] == [e.iterations for e in re]
          and all(np.array_equal(a.x, e.x) for a, e in zip(ra, re))
          and counts["stream stepped"] == counts["stream stepped eager"],
          "stream: graph and eager stepped passes differ")
    print("stream: stepped graph vs eager x bit-identical, same launches",
          flush=True)
    dx = max(float(np.max(np.abs(a.x - b.x))) for a, b in zip(ra, rb))
    print(f"stream: stepped vs megakernel max|dx|={dx:.3e}", flush=True)
    check([a.iterations for a in ra] == [b.iterations for b in rb],
          "stream: stepped and megakernel iterations differ")
    check(dx <= 1e-8, f"stream: x differs by {dx:.3e}")
    # the warm pass through the same solver builds nothing
    _, delta, st, _ = _stream_run("stream warm", solver, lps)
    check(st["compiles"] == 0, f"warm stream: {st['compiles']} compiles")
    counts["stream warm"] = delta
    return counts


# ------------------------------------------------------- distributed ---

def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_ranks(role: str, world: int, out_dir: str) -> list:
    """Run ``world`` processes of this script, rank r of ``role`` each,
    within ``DIST_TIMEOUT_S``; every process is stopped before this
    returns, and a rank that failed or outlived the limit fails the
    smoke.  Returns each rank's saved arrays."""
    import numpy as np

    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--role", role,
         "--rank", str(r), "--world", str(world), "--port", str(port),
         "--out", out_dir], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + DIST_TIMEOUT_S
    outs, failed = [None] * world, None
    try:
        for i, p in enumerate(procs):
            try:
                outs[i] = p.communicate(
                    timeout=max(0.1, deadline - time.monotonic()))[0]
            except subprocess.TimeoutExpired:
                failed = f"rank {i} still running after {DIST_TIMEOUT_S} s"
                break
            if p.returncode != 0:
                failed = f"rank {i} exited {p.returncode}"
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for i, p in enumerate(procs):
            if outs[i] is None:
                outs[i] = p.communicate()[0]
    for i, text in enumerate(outs):
        for line in text.splitlines()[-40:]:
            print(f"  {role}{world} rank {i}: {line}", flush=True)
    check(failed is None, f"{role} on {world} ranks: {failed}")
    return [dict(np.load(os.path.join(out_dir, f"{role}{world}-{r}.npz")))
            for r in range(world)]


def _init_rank(args, backend: str) -> None:
    """One rank of a process group on the one card."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend,
                            init_method=f"tcp://localhost:{args.port}",
                            rank=args.rank, world_size=args.world)


def role_dist(args) -> None:
    """A rank of ``solve_dist`` on the full-width instance: world 1 is a
    1x1 mesh over NCCL (the whole solve, then the fixed budget), world 4
    a 2x2 mesh over gloo on CUDA tensors (the fixed budget, and
    ``compressed_psum`` against the exact all-reduce)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import engine
    from repro_torch.core.pdhg import PDHGOptions
    from repro_torch.distributed import compressed_psum, solve_dist
    from repro_torch.launch import solve as cli
    from repro_torch.runtime.mesh import make_mesh

    one = args.world == 1
    backend = "nccl" if one else "gloo"
    _init_rank(args, backend)
    mesh = make_mesh((1, 1) if one else (2, 2), ("data", "model"),
                     backend=backend)
    lp = cli.load_instance(MAIN_INSTANCE)
    out = {}

    def run(label, opts, timed):
        kernels.reset_launch_counts()
        engine.COLLECTIVES["all_reduce"] = 0
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx = (engine.timed_collectives() if timed
               else contextlib.nullcontext())
        with ctx as coll:
            res = solve_dist(lp, mesh, opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        coll = coll or {"seconds": float("nan"), "calls": 0}
        out.update({f"{label}/x": res.x, f"{label}/iterations":
                    res.iterations, f"{label}/status": res.status,
                    f"{label}/merit": res.merit, f"{label}/wall": wall,
                    f"{label}/coll_s": coll["seconds"],
                    f"{label}/coll_calls": coll["calls"],
                    f"{label}/all_reduce": engine.COLLECTIVES["all_reduce"],
                    f"{label}/launches": json.dumps(kernels.launch_counts())})
        print(f"{label}: status={res.status} iterations={res.iterations} "
              f"wall_s={wall:.3f} all_reduce="
              f"{engine.COLLECTIVES['all_reduce']} in_all_reduce_s="
              f"{coll['seconds']:.6f}", flush=True)

    if one:
        run("solve", PDHGOptions(max_iters=MAX_ITERS, tol=TOL,
                                 check_every=CHECK_EVERY), timed=False)
    run("budget", PDHGOptions(max_iters=DIST_BUDGET, tol=0.0,
                              check_every=CHECK_EVERY), timed=True)
    if not one:
        # the quantized sum against the exact one, on CUDA tensors over
        # gloo (a max all-reduce, then an int32 sum)
        g = mesh.group(("data", "model"))
        gen = torch.Generator(device="cuda").manual_seed(args.rank)
        x = 3.0 * torch.randn(3840, generator=gen, dtype=torch.float64,
                              device="cuda")
        exact = engine.all_reduce(x.clone(), g)
        amax = float(engine.all_reduce(x.abs().max().reshape(1), g,
                                       op="max")[0])
        for bits in (8, 16):
            q = compressed_psum(x, g, bits=bits)
            out[f"psum{bits}/err"] = float((q - exact).abs().max())
            # the reference's bound, half a step of the global scale, for
            # each rank's share
            out[f"psum{bits}/bound"] = (args.world * 0.5 * amax
                                        / (2.0 ** (bits - 1) - 1.0))
        # stochastic rounding: under one step a rank
        q = compressed_psum(x, g, torch.Generator(device="cuda")
                            .manual_seed(7), bits=8)
        out["psum8s/err"] = float((q - exact).abs().max())
        out["psum8s/bound"] = args.world * amax / 127.0
    np.savez(os.path.join(args.out, f"dist{args.world}-{args.rank}.npz"),
             **out)
    dist.destroy_process_group()


def role_pod(args) -> None:
    """One pod of the small dense stream over a ``DirectoryTransport``."""
    import numpy as np
    import torch

    from repro_torch.core.pdhg import PDHGOptions
    from repro_torch.launch import solve as cli
    from repro_torch.runtime.cluster import (
        ClusterBatchSolver,
        DirectoryTransport,
    )

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    lps = [cli.load_instance(s, seed=i)
           for i, s in enumerate(SMALL_DENSE.split(","))]
    solver = ClusterBatchSolver(
        PDHGOptions(max_iters=MAX_ITERS, tol=TOL, check_every=CHECK_EVERY),
        pod=args.rank, n_pods=args.world, live_pods=args.world,
        transport=DirectoryTransport(os.path.join(args.out, "transport")),
        straggler_timeout=60.0, gather_timeout=DIST_TIMEOUT_S)
    res = solver.solve_stream(lps)
    st = solver.last_stream_stats
    print(f"pod {args.rank}: routing={st['routing']} local_buckets="
          f"{st['n_local_buckets']} rerouted={st['rerouted_buckets']}",
          flush=True)
    np.savez(os.path.join(args.out, f"pod{args.world}-{args.rank}.npz"),
             x=np.concatenate([r.x for r in res]),
             y=np.concatenate([r.y for r in res]),
             iterations=[r.iterations for r in res],
             merit=[r.merit for r in res],
             routing=json.dumps(st["routing"]))


def phase_distributed(stepped):
    """The distributed path through ``solve_dist`` and the cluster
    solver, each rank its own process; returns the launch counts of the
    1x1 solve and of the 2x2 budget's rank 0."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core.pdhg import PDHGOptions
    from repro_torch.launch import solve as cli
    from repro_torch.runtime import BatchSolver

    tmp = tempfile.mkdtemp(prefix="chip-smoke-dist-")
    try:
        t0 = time.perf_counter()
        (one,) = _spawn_ranks("dist", 1, tmp)
        print(f"dist 1x1: ranks done in {time.perf_counter() - t0:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        four = _spawn_ranks("dist", 4, tmp)
        print(f"dist 2x2: ranks done in {time.perf_counter() - t0:.1f}s",
              flush=True)
        t0 = time.perf_counter()
        pods = _spawn_ranks("pod", 2, tmp)
        print(f"dist pods: ranks done in {time.perf_counter() - t0:.1f}s",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    it = int(one["solve/iterations"])
    dx = float(np.abs(one["solve/x"] - stepped.x).max())
    wall = float(one["solve/wall"])
    print(f"dist 1x1 nccl {MAIN_INSTANCE}: status={one['solve/status']} "
          f"iterations={it} wall_s={wall:.3f} us_per_step="
          f"{1e6 * wall / it:.3f} all_reduce={int(one['solve/all_reduce'])} "
          f"max|dx| vs stepped solve_jit={dx:.3e}", flush=True)
    check(str(one["solve/status"]) == "optimal" and it == stepped.iterations,
          f"dist 1x1: {one['solve/status']} in {it} iterations, "
          f"solve_jit {stepped.iterations}")
    check(dx <= 1e-10, f"dist 1x1: x differs from solve_jit by {dx:.3e}")
    for label, res, path in (("1x1 nccl", one, "solve"),
                             ("1x1 nccl", one, "budget"),
                             ("2x2 gloo, 4 ranks on 1 card", four[0],
                              "budget")):
        steps = int(res[f"{path}/iterations"])
        d = json.loads(str(res[f"{path}/launches"]))
        want = stepped_launches(steps)
        check(d == want, f"dist {label} {path}: launches {d}, expected "
                         f"{want}")
        # two all-reduces a step, eight a check, the norm and two gathers
        n_coll = int(res[f"{path}/all_reduce"])
        check(n_coll == 2 * steps + 8 * (steps // CHECK_EVERY) + 3,
              f"dist {label} {path}: {n_coll} all-reduces")
        if path == "budget":
            w, c = float(res["budget/wall"]), float(res["budget/coll_s"])
            print(f"dist {label} budget: iterations={steps} wall_s={w:.3f} "
                  f"us_per_step={1e6 * w / steps:.3f} in_all_reduce_s="
                  f"{c:.6f} ({int(res['budget/coll_calls'])} calls, "
                  f"share={c / w:.4f} of the wall)", flush=True)
    dx4 = float(np.abs(four[0]["budget/x"] - one["budget/x"]).max())
    print(f"dist 2x2 vs 1x1 at {DIST_BUDGET} steps: max|dx|={dx4:.3e}",
          flush=True)
    check(int(one["budget/iterations"]) == DIST_BUDGET
          and all(int(r["budget/iterations"]) == DIST_BUDGET
                  and np.array_equal(r["budget/x"], four[0]["budget/x"])
                  for r in four),
          "dist: the budget runs' iterations or ranks differ")
    check(dx4 <= 1e-9, f"dist 2x2: x differs from 1x1 by {dx4:.3e}")
    for r, res in enumerate(four):
        for key in ("psum8", "psum16", "psum8s"):
            err, bound = float(res[f"{key}/err"]), float(res[f"{key}/bound"])
            check(err <= bound * (1 + 1e-9),
                  f"compressed_psum {key} rank {r}: {err:.3e} > {bound:.3e}")
    print("dist compressed_psum on CUDA over gloo (err/bound): "
          + " ".join(f"{k}={float(four[0][k + '/err']):.3e}/"
                     f"{float(four[0][k + '/bound']):.3e}"
                     for k in ("psum8", "psum16", "psum8s")), flush=True)
    lps = [cli.load_instance(s, seed=i)
           for i, s in enumerate(SMALL_DENSE.split(","))]
    base = BatchSolver(PDHGOptions(max_iters=MAX_ITERS, tol=TOL,
                                   check_every=CHECK_EVERY)).solve_stream(lps)
    routing = json.loads(str(pods[0]["routing"]))
    print(f"dist pods: routing={routing}", flush=True)
    check(set(routing.values()) == {0, 1}, f"pods: routing {routing}")
    for r, res in enumerate(pods):
        check(np.array_equal(res["x"], np.concatenate([b.x for b in base]))
              and np.array_equal(res["y"], np.concatenate(
                  [b.y for b in base]))
              and list(res["iterations"]) == [b.iterations for b in base]
              and list(res["merit"]) == [b.merit for b in base],
              f"pods: pod {r}'s stream differs from one BatchSolver's")
    print("dist pods: both pods' streams bitwise one BatchSolver's",
          flush=True)
    return {"distributed 1x1": json.loads(str(one["solve/launches"])),
            "distributed 2x2 budget": json.loads(
                str(four[0]["budget/launches"]))}


# the LM serving phase: (a) decode against forward at every config's
# published widths, depth cut to LM_CHECK_LAYERS, in f32, at the
# reference test's tolerance (tests/test_models.py:81-82); (b) serving in
# bf16 at full depth: the main cell (granite-3-8b, LM_MAIN_BATCH x
# LM_MAIN_PROMPT-token prompts, LM_MAIN_NEW greedy tokens), every other
# config that fits the card whole (LM_BATCH x LM_PROMPT, LM_NEW), and
# grok-1-314b (631 GB in bf16) at its full width and LM_REDUCED layers
LM_MAIN = "granite-3-8b"
LM_MAIN_BATCH, LM_MAIN_PROMPT, LM_MAIN_NEW = 8, 1024, 64
LM_BATCH, LM_PROMPT, LM_NEW = 8, 256, 32
LM_REDUCED = {"grok-1-314b": 2}
LM_CHECK_LAYERS, LM_CHECK_BATCH, LM_CHECK_TOKENS = 2, 2, 12
LM_ATOL, LM_RTOL = 2e-2, 0.05
# the main cell's decode steps traced by torch.profiler (after the first
# step, before the timed ones): the card's busy share of a step
LM_PROFILE_STEPS = 4


def _lm_order():
    """The registry's configs, the largest (grok-1) last."""
    from repro_torch.configs import ARCH_NAMES

    return ([a for a in ARCH_NAMES if a not in LM_REDUCED]
            + [a for a in ARCH_NAMES if a in LM_REDUCED])


def _lm_inputs(cfg, params, toks):
    """The prompt as ``forward`` takes it: the vision and audio configs
    feed embeddings (the embedding rows of the tokens, so the decode
    path, which takes tokens, sees the same input)."""
    if cfg.frontend in ("vision", "audio"):
        return {"embeddings": params["embed"][toks.long()]}
    return {"tokens": toks}


def _lm_decode_check(arch: str) -> dict:
    """(a): ``forward`` against token-by-token ``decode_step`` at the
    published widths, LM_CHECK_LAYERS layers, f32.  The MoE configs run
    with a capacity that drops nothing (``n_experts / top_k``): capacity
    routing drops by group size, which a prompt's forward and a
    one-token decode do not share, so the published capacity's gap is
    printed beside it and not held to the tolerance."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, forward, init_cache, \
        init_params

    cfg = dataclasses.replace(get_config(arch), n_layers=LM_CHECK_LAYERS,
                              dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    B, S = LM_CHECK_BATCH, LM_CHECK_TOKENS
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen,
                         device="cuda", dtype=torch.int32)

    def gap(c):
        with torch.no_grad():
            full = forward(params, c, **_lm_inputs(c, params, toks))
            cache = init_cache(c, B, S, device="cuda")
            dec = torch.stack([decode_step(params, c, toks[:, t:t + 1],
                                           cache)[0] for t in range(S)],
                              dim=1)
        scale = float(full.abs().max())
        excess = float(((dec - full).abs() - LM_ATOL * scale
                        - LM_RTOL * full.abs()).max())
        return (float((dec - full).abs().max()), scale, excess,
                bool(torch.isfinite(dec).all() and torch.isfinite(full).all()))

    row = {"arch": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "params": sum(p.numel() for p in _leaves(params))}
    if cfg.mlp == "moe":
        row["published_capacity_max_abs_err"] = gap(cfg)[0]
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                  / cfg.top_k)
        row["capacity_factor"] = cfg.capacity_factor
    err, scale, excess, finite = gap(cfg)
    row.update(max_abs_err=err, max_abs_logit=scale, finite=finite,
               ok=finite and excess <= 0)
    del params
    torch.cuda.empty_cache()
    return row


def _profiled(fn):
    """``fn()`` once under ``torch.profiler``: (its result, the card's
    busy share of the wall or None when the trace holds no device event,
    the wall in ms, device ms by kernel name).  The profiler's own host
    cost lengthens the wall, so the share is a lower bound."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:80]] += e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values()) * 1e3 / wall_us if by_name else None
    return out, busy, wall_us / 1e3, by_name


def _device_busy(step, n: int):
    """Run ``step`` ``n`` times under ``torch.profiler``: (the time of
    the card's kernels and copies over the wall, the wall in ms), as
    ``_profiled`` gives them."""
    def steps():
        for _ in range(n):
            step()

    return _profiled(steps)[1:3]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _lm_serve(arch: str) -> dict:
    """(b): one config in bf16 at full depth (or LM_REDUCED's): random
    weights from a seed on the card, ``make_prefill_step`` over the
    prompts (timed), the cache filled with all but the prompts' last
    token (``lm.prefill_cache``, timed), then ``make_serve_step`` from
    the last prompt token on, a token a step (timed): its first logits
    are the decode path's at the prompts' end, held beside prefill's."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.lm import padded_vocab, prefill_cache
    from repro_torch.train import make_prefill_step, make_serve_step

    cfg = get_config(arch)
    reduced = arch in LM_REDUCED
    if reduced:
        cfg = dataclasses.replace(cfg, n_layers=LM_REDUCED[arch])
    main = arch == LM_MAIN
    B, P, new = ((LM_MAIN_BATCH, LM_MAIN_PROMPT, LM_MAIN_NEW) if main
                 else (LM_BATCH, LM_PROMPT, LM_NEW))
    V = padded_vocab(cfg)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_params(cfg, gen, device="cuda")
    toks = torch.randint(0, cfg.vocab, (B, P), generator=gen,
                         device="cuda", dtype=torch.int32)
    batch = _lm_inputs(cfg, params, toks)
    prefill, serve = make_prefill_step(cfg), make_serve_step(cfg)
    prefill(params, {k: v[:, :16] for k, v in batch.items()})  # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    cache = init_cache(cfg, B, P + new, device="cuda")
    t0 = time.perf_counter()
    prefill_cache(params, cfg, cache,
                  **{k: v[:, :P - 1] for k, v in batch.items()})
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    tok, out, finite = toks[:, P - 1:], [], [torch.isfinite(last).all()]

    def step():
        nonlocal tok
        nxt, logits, _ = serve(params, tok, cache)
        finite.append(torch.isfinite(logits).all())
        tok = nxt[:, None]
        out.append(tok)
        return logits

    first = step()                  # the prompts' last token
    busy, busy_ms = (_device_busy(step, LM_PROFILE_STEPS) if main
                     else (None, None))
    timed = new - len(out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        logits = step()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    finite = torch.stack(finite).all()
    gen_toks = torch.cat(out, dim=1)
    agree = float((first.float() - last.float()).abs().max()
                  / last.float().abs().max())
    argmax_agree = float((first.argmax(-1) == last.argmax(-1))
                         .float().mean())
    check(bool(finite), f"lm {arch}: a logit is not finite")
    check(tuple(last.shape) == (B, V) and tuple(logits.shape) == (B, V),
          f"lm {arch}: logits {tuple(last.shape)} / {tuple(logits.shape)}, "
          f"expected {(B, V)}")
    check(tuple(gen_toks.shape) == (B, new)
          and int(gen_toks.min()) >= 0 and int(gen_toks.max()) < V,
          f"lm {arch}: greedy tokens outside the vocabulary")
    row = {"arch": arch, "dtype": cfg.dtype, "layers": cfg.n_layers,
           "reduced": (f"n_layers {cfg.n_layers} of "
                       f"{get_config(arch).n_layers}" if reduced else None),
           "params": sum(p.numel() for p in _leaves(params)),
           "batch": B, "prompt": P, "new_tokens": new,
           "cache_slots": P + new,
           "cache_bytes": sum(c.numel() * c.element_size()
                              for c in _leaves(cache)),
           "prefill_ms": prefill_s * 1e3,
           "cache_fill_ms": fill_s * 1e3,
           "decode_ms_per_token": decode_s * 1e3 / timed,
           "decode_tokens_per_s": B * timed / decode_s,
           "decode_steps_timed": timed,
           # every weight and the cache read once a step (the MoE
           # dispatch reads every expert), over the card's memory rate
           "decode_floor_ms": (sum(p.numel() * p.element_size()
                                   for p in _leaves(params))
                               + sum(c.numel() * c.element_size()
                                     for c in _leaves(cache)))
           / HBM_BYTES_PER_S * 1e3,
           "decode_device_busy_share": busy,
           "decode_profiled_ms_per_token": (busy_ms / LM_PROFILE_STEPS
                                            if main else None),
           "prefill_tokens_per_s": B * P / prefill_s,
           "decode_vs_prefill_rel_err": agree,
           "decode_vs_prefill_argmax_agree": argmax_agree,
           "pad_row_tokens": int((gen_toks >= cfg.vocab).sum()),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del params, cache, batch, last, logits, first
    torch.cuda.empty_cache()
    return row


def phase_lm_serve() -> dict:
    """The LM substrate's serving path (``repro_torch.models``,
    ``train.serve_step``): (a) for every config, then (b).  It reaches
    no hand-written kernel (its products are torch matmuls, as the
    reference's are plain jnp): the launch counts, zeroed before it and
    read after, must stay 0."""
    from repro_torch import kernels

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    for arch in _lm_order():
        t0 = time.perf_counter()
        row = _lm_decode_check(arch)
        row["wall_s"] = time.perf_counter() - t0
        print("lm check " + json.dumps(row), flush=True)
        check(row["ok"], f"lm {arch}: decode disagrees with forward beyond "
              f"atol={LM_ATOL}*max|logits|, rtol={LM_RTOL}")
    for arch in [LM_MAIN] + [a for a in _lm_order() if a != LM_MAIN]:
        t0 = time.perf_counter()
        row = _lm_serve(arch)
        row["wall_s"] = time.perf_counter() - t0
        print("lm serve " + json.dumps(row), flush=True)
    counts = kernels.launch_counts()
    check(not any(counts.values()),
          f"lm serving launched a hand-written kernel: {counts}")
    print(f"lm serve: phase {time.perf_counter() - t_phase:.1f}s, "
          f"hand-written kernel launches {sum(counts.values())}",
          flush=True)
    return {"lm serve": counts}


# the LM training phase: (a) every config at its published widths,
# TRAIN_CHECK_LAYERS layers, f32, TRAIN_CHECK_BATCH x TRAIN_CHECK_SEQ
# tokens from synth_batch, MoE at a dropless capacity (grok-1-314b's 2
# layers, its weights, gradients and an f64 copy do not fit the card: 1
# layer in bf16 with Adafactor, loss and finiteness only); (b) the
# full-width training cells, whole models in bf16 with remat,
# TRAIN_BATCH x TRAIN_SEQ tokens a step, TRAIN_STEPS steps, each with
# launch.train's default optimizer where it fits (granite-3-8b's AdamW
# moments, 65 GB in f32, do not fit beside its weights and gradients:
# Adafactor, the reference's low-memory option)
TRAIN_CHECK_LAYERS, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 2, 64
TRAIN_REDUCED = {"grok-1-314b": 1}
# the train step's loss against cross_entropy(forward) under no_grad:
# the same products, so f32 rounding (bf16 for the reduced config)
TRAIN_LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
TRAIN_F64_TOL = 1e-4       # max|g32 - g64| <= tol * max|g64|, a leaf
TRAIN_REMAT_TOL = 1e-6     # max|g_remat - g| <= tol * max|g|, a leaf
TRAIN_CELLS = (("starcoder2-3b", "adamw"), ("granite-3-8b", "adafactor"))
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 10
TRAIN_TIMED_FROM = 3       # ms a step: the median of steps 3..10
TRAIN_PROFILED = 1         # step 2 (not timed) runs under torch.profiler
# granite's microbatch=2 step against the plain one from the same state:
# the reference test's bounds (tests/test_train.py:62-65)
TRAIN_MICRO, TRAIN_MICRO_LOSS_RTOL, TRAIN_MICRO_PARAM_TOL = 2, 1e-5, 5e-3
BF16_PEAK_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)


def _device_batch(batch: dict) -> dict:
    import torch

    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def _leaf_rel_err(got, ref) -> float:
    """max over leaves of max|got - ref| / max|ref| (each leaf its own
    scale; a leaf of zeros must be zero)."""
    worst = 0.0
    for (_, a), (_, b) in zip(_paths(got), _paths(ref)):
        err = float((a.double() - b.double()).abs().max())
        scale = float(b.double().abs().max())
        worst = max(worst, err / scale if scale > 0
                    else (0.0 if err == 0 else float("inf")))
    return worst


def _paths(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def _train_check(arch: str) -> dict:
    """(a): one config at its published widths, TRAIN_CHECK_LAYERS
    layers, f32 (TRAIN_REDUCED: fewer layers, bf16, Adafactor)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    from repro_torch.train import (DataConfig, TrainConfig, cross_entropy,
                                   init_opt_state, make_loss_fn,
                                   make_train_step, synth_batch)
    from repro_torch.train.train_step import value_and_grad

    reduced = arch in TRAIN_REDUCED
    cfg = dataclasses.replace(
        get_config(arch),
        n_layers=TRAIN_REDUCED.get(arch, TRAIN_CHECK_LAYERS),
        dtype="bfloat16" if reduced else "float32")
    if cfg.mlp == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                                  / cfg.top_k)
    tcfg = TrainConfig(optimizer="adafactor" if reduced else "adamw")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(cfg, gen, device="cuda")
    batch = _device_batch(synth_batch(DataConfig(
        cfg.vocab, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ, seed=0,
        embeddings_dim=cfg.d_model
        if cfg.frontend in ("vision", "audio") else 0), 0))
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    row = {"arch": arch, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "optimizer": tcfg.optimizer, "d_model": cfg.d_model,
           "params": sum(p.numel() for p in _leaves(params)),
           "reduced": (f"n_layers {cfg.n_layers}, bf16, Adafactor"
                       if reduced else None)}
    with torch.no_grad():
        plain = float(cross_entropy(forward(params, cfg, **inputs),
                                    batch["labels"], tcfg.z_loss))
    _, grads = value_and_grad(make_loss_fn(cfg, tcfg), params, batch)
    row["grads_finite"] = all(bool(torch.isfinite(g).all())
                              for g in _leaves(grads))
    if not reduced:
        _, g_plain = value_and_grad(
            make_loss_fn(cfg, dataclasses.replace(tcfg, remat=False)),
            params, batch)
        row["remat_rel_err"] = _leaf_rel_err(grads, g_plain)
        del g_plain
        cfg64 = dataclasses.replace(cfg, dtype="float64")
        p64 = _map_tree(lambda t: t.double(), params)
        b64 = {k: v.double() if v.is_floating_point() else v
               for k, v in batch.items()}
        _, g64 = value_and_grad(make_loss_fn(cfg64, tcfg), p64, b64)
        row["f64_rel_err"] = _leaf_rel_err(grads, g64)
        del p64, g64
    del grads
    torch.cuda.empty_cache()
    _, _, metrics = make_train_step(cfg, tcfg)(
        params, init_opt_state(params, tcfg), batch)
    row.update(loss=float(metrics["loss"]), loss_no_grad=plain,
               loss_rel_err=abs(float(metrics["loss"]) - plain) / abs(plain))
    del params
    torch.cuda.empty_cache()
    return row


def _map_tree(fn, tree):
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _train_micro_check(cfg, params, opt, batch, step, tcfg) -> dict:
    """One ``microbatch=TRAIN_MICRO`` step and then the plain step from
    the same parameters and state (the parameters are saved on the host:
    a second copy beside the microbatched step's f32 accumulators does
    not fit the card).  Returns (the comparison, and the parameters and
    state after the plain step, which is the cell's first)."""
    import torch

    from repro_torch.train import make_train_step

    host = _map_tree(lambda t: t.to("cpu", copy=True), params)
    opt0 = _map_tree(torch.clone, opt)
    micro = make_train_step(cfg, dataclasses.replace(
        tcfg, microbatch=TRAIN_MICRO))
    torch.cuda.reset_peak_memory_stats()
    _, _, m_micro = micro(params, opt0, batch)
    micro_peak = torch.cuda.max_memory_allocated()
    p_micro = _map_tree(torch.clone, params)
    del opt0
    for (_, dst), (_, src) in zip(_paths(params), _paths(host)):
        dst.copy_(src)
    del host
    params, opt, m = step(params, opt, batch)
    diff = max(float((a.float() - b.float()).abs().max())
               for (_, a), (_, b) in zip(_paths(params), _paths(p_micro)))
    del p_micro
    torch.cuda.empty_cache()
    loss, loss_micro = float(m["loss"]), float(m_micro["loss"])
    return ({"loss": loss, "loss_micro": loss_micro,
             "loss_rel_err": abs(loss - loss_micro) / abs(loss),
             "param_max_abs_diff": diff, "micro_peak_bytes": micro_peak},
            params, opt)


def _kernel_kinds(by_name) -> dict:
    """Device ms by kind of kernel: GEMMs by their operand type (cuBLAS's
    bf16 ``nvjet`` kernels; its f32 ``xmma ... f32 ... ffma`` ones, the
    f32 attention with TF32 off), elementwise and reduction kernels, and
    the rest."""
    kinds = {"gemm_bf16": 0.0, "gemm_f32": 0.0, "elementwise": 0.0,
             "reduce": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        if "nvjet" in name or ("gemm" in name and "bf16" in name):
            kinds["gemm_bf16"] += ms
        elif "gemm" in name:
            kinds["gemm_f32"] += ms
        elif "elementwise" in name:
            kinds["elementwise"] += ms
        elif "reduce" in name.lower():
            kinds["reduce"] += ms
        else:
            kinds["other"] += ms
    return kinds


def _train_cell(arch: str, optimizer: str) -> dict:
    """(b): one config whole in bf16 with remat, TRAIN_STEPS steps of
    TRAIN_BATCH x TRAIN_SEQ tokens from the Prefetcher."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.train import (DataConfig, Prefetcher, TrainConfig,
                                   init_opt_state, make_train_step)

    cfg = get_config(arch)
    tcfg = TrainConfig(optimizer=optimizer, remat=True)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = init_params(cfg, gen, device="cuda")
    opt = init_opt_state(params, tcfg)
    step = make_train_step(cfg, tcfg)
    data = Prefetcher(DataConfig(
        cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, seed=0,
        embeddings_dim=cfg.d_model
        if cfg.frontend in ("vision", "audio") else 0))
    row = {"arch": arch, "optimizer": optimizer, "dtype": cfg.dtype,
           "layers": cfg.n_layers, "remat": tcfg.remat,
           "params": sum(p.numel() for p in _leaves(params)),
           "active_params": cfg.active_param_count(),
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS}
    losses, times = [], []
    try:
        for i in range(TRAIN_STEPS):
            batch = _device_batch(next(data))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0 and arch == TRAIN_CELLS[-1][0]:
                row["micro"], params, opt = _train_micro_check(
                    cfg, params, opt, batch, step, tcfg)
                losses.append(row["micro"]["loss"])
                torch.cuda.reset_peak_memory_stats()
            elif i == TRAIN_PROFILED:
                (params, opt, m), busy, wall_ms, by_name = _profiled(
                    partial(step, params, opt, batch))
                losses.append(float(m["loss"]))
                row.update(profiled_step=i + 1, device_busy_share=busy,
                           profiled_ms=wall_ms,
                           device_ms_by_kind=_kernel_kinds(by_name),
                           top_kernels_ms=[[n, ms] for n, ms in
                                           by_name.most_common(8)])
            else:
                params, opt, m = step(params, opt, batch)
                losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        data.close()
    ms = statistics.median(times[TRAIN_TIMED_FROM - 1:]) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    row.update(
        ms_per_step=ms, step_ms=[t * 1e3 for t in times],
        tokens_per_s=tokens / (ms / 1e3),
        mfu=6.0 * row["active_params"] * tokens / (ms / 1e3
                                                   * BF16_PEAK_FLOPS),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        loss_first=losses[0], loss_last=losses[-1], losses=losses)
    del params, opt
    torch.cuda.empty_cache()
    return row


def phase_lm_train() -> dict:
    """The LM substrate's training path: (a) for every config, then (b).
    It reaches no hand-written kernel (autograd over torch matmuls, as
    the reference's value_and_grad over plain jnp products) and starts
    no CUDA graph: the launch counts, zeroed before it, stay 0, and
    ``engine.GRAPHS`` does not move."""
    import math

    import torch

    from repro_torch import kernels

    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    graphs_before = graphs()
    # the microbatched granite step holds the bf16 weights, their f32
    # accumulators and a microbatch's bf16 gradients (65 GB): segments
    # that grow in place keep the free memory in one piece
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        _phase_lm_train_rows()
    finally:
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")
    counts = kernels.launch_counts()
    check(not any(counts.values()),
          f"lm training launched a hand-written kernel: {counts}")
    check(graphs() == graphs_before,
          f"lm training moved engine.GRAPHS: {graphs_before} -> {graphs()}")
    print(f"lm train: phase {time.perf_counter() - t_phase:.1f}s, "
          f"hand-written kernel launches {sum(counts.values())}, "
          f"CUDA graphs {graphs()}", flush=True)
    return {"lm train": counts}


def _phase_lm_train_rows() -> None:
    """Phase 10's rows, printed and checked as they come."""
    import math

    import torch

    for arch in _lm_order():
        t0 = time.perf_counter()
        row = _train_check(arch)
        row["wall_s"] = time.perf_counter() - t0
        print("lm train check " + json.dumps(row), flush=True)
        tol = TRAIN_LOSS_RTOL[row["dtype"]]
        check(row["grads_finite"], f"lm train {arch}: a gradient is not "
              "finite")
        check(math.isfinite(row["loss"]) and row["loss_rel_err"] <= tol,
              f"lm train {arch}: the step's loss {row['loss']} against "
              f"cross_entropy(forward) {row['loss_no_grad']}: beyond "
              f"rtol={tol}")
        if row["reduced"] is None:
            rel = row["f64_rel_err"]
            check(rel <= TRAIN_F64_TOL,
                  f"lm train {arch}: f32 gradients {rel:.3g} of max|g64| "
                  f"from the f64 copy's, over {TRAIN_F64_TOL}")
            rel = row["remat_rel_err"]
            check(rel <= TRAIN_REMAT_TOL,
                  f"lm train {arch}: remat gradients {rel:.3g} of max|g| "
                  f"from the plain ones, over {TRAIN_REMAT_TOL}")
    for arch, optimizer in TRAIN_CELLS:
        t0 = time.perf_counter()
        row = _train_cell(arch, optimizer)
        row["wall_s"] = time.perf_counter() - t0
        print("lm train " + json.dumps(row), flush=True)
        check(all(math.isfinite(v) for v in row["losses"]),
              f"lm train {arch}: a loss is not finite: {row['losses']}")
        check(row["loss_last"] < row["loss_first"],
              f"lm train {arch}: the loss did not fall in "
              f"{TRAIN_STEPS} steps: {row['losses']}")
        if "micro" in row:
            mc = row["micro"]
            check(mc["loss_rel_err"] <= TRAIN_MICRO_LOSS_RTOL
                  and mc["param_max_abs_diff"] < TRAIN_MICRO_PARAM_TOL,
                  f"lm train {arch}: microbatch={TRAIN_MICRO} against the "
                  f"plain step: loss rel {mc['loss_rel_err']:.3g} (rtol "
                  f"{TRAIN_MICRO_LOSS_RTOL}), parameters "
                  f"{mc['param_max_abs_diff']:.3g} (< "
                  f"{TRAIN_MICRO_PARAM_TOL})")
        torch.cuda.empty_cache()


# the full-width path on which each kernel's ``launches`` is read: the
# stepped loop runs B1's and B2's step forms, and B1 and B2 themselves
# run on the host driver, which steps ``engine.pdhg_step``; the stepped
# loop's kernels are read from its eager run, where each launch is
# counted where it launches (a replay adds the counts of its capture)
MAIN_PATH_OF = {"dual_update": "host full", "primal_update": "host full",
                "schedule": "stepped eager", "dual_step": "stepped eager",
                "primal_step": "stepped eager",
                "fused_dense_steps": "jit noiseless megakernel",
                "fused_dense_steps_kt": "megakernel",
                "ell_matvec": "stream stepped eager",
                "fused_ell_steps": "stream megakernel",
                "crossbar_mvm": "host full"}


# phase 11: the dry run's counts on this machine's torch against those
# written below, three cells cut to 2 layers: the reference test's decode
# cell (tests/test_dryrun.py), olmoe's two-pod train cell (its strided
# microbatch split, MoE) and a prefill cell (attention's views); each
# artifact goes under build/ (ignored by git)
DRYRUN_COUNTS_TORCH = "2.13.0+cpu"     # the torch the counts came from
DRYRUN_COUNTS = {
    # (arch, shape, multi_pod): peak bytes a device, FLOPs a device,
    # collective bytes a device
    ("starcoder2-3b", "decode_32k", True): (60768296, 410517504.0,
                                            53912064.0),
    ("olmoe-1b-7b", "train_4k", True): (2397912084, 12768937771008.0,
                                        20548943888.0),
    ("qwen3-14b", "prefill_32k", False): (4750723072, 12008923037696.0,
                                          10958464096.0),
}
DRYRUN_REL = 0.01
DRYRUN_TIMEOUT = 300


def phase_dryrun() -> None:
    import torch

    print(f"dryrun: torch {torch.__version__} (counts written on torch "
          f"{DRYRUN_COUNTS_TORCH})", flush=True)
    out = os.path.join(HERE, "build", "dryrun_smoke")
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    t0 = time.perf_counter()
    try:
        for cell in DRYRUN_COUNTS:
            arch, shape, multi = cell
            code = ("from repro_torch.launch import dryrun; "
                    f"dryrun.run_cell({arch!r}, {shape!r}, {multi!r}, "
                    f"{out!r}, cfg_overrides={{'n_layers': 2}})")
            procs[cell] = subprocess.Popen(
                [sys.executable, "-c", code], env=env, cwd=HERE,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cell, proc in procs.items():
            _, err = proc.communicate(
                timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
            check(proc.returncode == 0, f"dry run {cell} exited "
                  f"{proc.returncode}: {err[-2000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for (arch, shape, multi), want in DRYRUN_COUNTS.items():
        tag = f"{arch}_{shape}_{'2x16x16' if multi else '16x16'}"
        with open(os.path.join(out, f"{tag}.json")) as f:
            cell = json.load(f)
        check("error" not in cell, f"dry run {tag}: {cell.get('error')}")
        got = (cell["memory"]["peak_per_device_bytes"],
               cell["op_estimate"]["flops"],
               cell["collectives"]["total_bytes"])
        if shape == "decode_32k":
            check(0 < got[0] < 16 * 2**30, f"dry run {tag}: peak {got[0]} "
                  "bytes a device, over the reference test's 16 GiB")
        for name, g, w in zip(("peak", "FLOPs", "collective bytes"), got,
                              want):
            check(abs(g - w) <= DRYRUN_REL * w,
                  f"dry run {tag}: {name} {g} a device, not within "
                  f"{DRYRUN_REL:.0%} of {w} (torch {DRYRUN_COUNTS_TORCH})")
        rf = cell["roofline"]
        print(f"dryrun: {tag} (2 layers) peak/dev={got[0] / 2**30:.3f}GiB "
              f"({got[0]} bytes) flops/dev={got[1]:.6e} "
              f"collective bytes/dev={got[2]:.6e} "
              f"bottleneck={rf['bottleneck']} trace {cell['trace_s']}s",
              flush=True)
    print(f"dryrun: three cells in {wall:.1f}s, all within "
          f"{DRYRUN_REL:.0%} of torch {DRYRUN_COUNTS_TORCH}'s counts "
          "(host CPU counts, not device metrics)", flush=True)


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--probe", default=None,
                    help="comma-separated scales: run only the stepped "
                         "full-width sparse stream at each, within the "
                         "CLI's iteration budget")
    # one rank of the distributed phase (the smoke starts these itself)
    ap.add_argument("--role", default=None, choices=["dist", "pod"],
                    help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--lm", action="store_true",
                    help="run only the LM serving phase")
    ap.add_argument("--train", action="store_true",
                    help="run only the LM training phase")
    args = ap.parse_args()
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
    if args.role is not None:
        {"dist": role_dist, "pod": role_pod}[args.role](args)
        return 0

    smi = nvidia_smi()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if args.lm or args.train:
        if args.lm:
            phase_lm_serve()
        if args.train:
            phase_lm_train()
        print(smi, flush=True)
        return 0

    from repro_torch.kernels import _build

    built = _build.build(verbose=True)
    print(f"build: {built.seconds:.1f}s -> {built.path}", flush=True)
    for line in built.log.splitlines():
        if ("registers" in line or "Compiling entry" in line
                or "spill" in line):
            print(f"  ptxas {line.strip()}", flush=True)
    attrs = kernel_attrs_lines()

    if args.probe:
        for scale in (int(v) for v in args.probe.split(",")):
            t0 = time.perf_counter()
            lps = stream_instances(scale)
            print(f"probe scale={scale}: generated in "
                  f"{time.perf_counter() - t0:.3f}s", flush=True)
            res = phase_stream(lps, probe=True)
            print(f"probe scale={scale}: all optimal="
                  f"{all(r.status == 'optimal' for r in res)}", flush=True)
            del lps, res
            torch.cuda.empty_cache()
        print(smi, flush=True)
        return 0

    print(f"build yardstick: one nvcc over all sources "
          f"{one_nvcc_build_seconds(_build):.1f}s", flush=True)

    from repro_torch.crossbar import TAOX_HFOX

    t0 = time.perf_counter()
    lps = stream_instances(STREAM_SCALE)
    bucket = main_bucket(lps)
    print(f"stream: generated and stacked in "
          f"{time.perf_counter() - t0:.3f}s; main bucket {bucket[0]}",
          flush=True)
    m, n = (int(v) for v in MAIN_INSTANCE.split(":")[1].split("x"))
    rows = phase_kernels(m, n, CHECK_EVERY)
    for name, extra in phase_dense_forms(CHECK_EVERY).items():
        rows[name] += extra
    rows["crossbar_mvm"] = phase_crossbar_kernel(m + n, TAOX_HFOX.sigma_read)
    ell_rows = phase_ell_kernels(bucket, CHECK_EVERY)
    del bucket
    torch.cuda.empty_cache()
    rows.update(ell_matvec=ell_rows["ell_matvec"],
                fused_ell_steps=ell_rows["fused_ell_steps"])
    counts, stepped = phase_main(MAIN_INSTANCE)
    counts.update(phase_crossbar(MAIN_INSTANCE))
    counts.update(phase_small_streams())
    counts.update(phase_stream(lps))
    del lps
    torch.cuda.empty_cache()
    counts.update(phase_distributed(stepped))
    torch.cuda.empty_cache()
    counts.update(phase_lm_serve())
    torch.cuda.empty_cache()
    counts.update(phase_lm_train())
    phase_dryrun()

    line = []
    extras = ("call_ms", "yardstick_ms", "gemv_ms", "adjoint_ms",
              "nnz_bound_ms", "reread_floor_ms", "all_slots_ms",
              "adjoint_all_slots_ms", "adjoint_library_ms",
              "adjoint_nnz_bound_ms", "all_slots_bound_ms", "nnz",
              "adjoint_nnz", "half_masked_ms", "all_slots_reread_floor_ms",
              "local_gather_ms", "ms_runs", "window_eager_ms",
              "window_graph_ms", "window_pdhg_step_ms", "window_gemv_ms")
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
        for extra in extras:
            if extra in main_row:
                entry[extra] = main_row[extra]
        if name in attrs:
            entry["attrs"] = attrs[name]
        f32 = next(r for r in rows[name]
                   if r["dtype"] == "float32" and "ms" in r)
        entry["f32"] = {"ms": f32["ms"], "plain_ms": f32["plain_ms"],
                        "bound_ms": f32["bound"][0],
                        "library_ms": f32["library_ms"],
                        "max_abs_err": max(r["max_abs_err"] for r in rows[name]
                                           if r["dtype"] == "float32"),
                        "rel_err": max(r["rel_err"] for r in rows[name]
                                       if r["dtype"] == "float32")}
        for extra in extras:
            if extra in f32:
                entry["f32"][extra] = f32[extra]
        line.append(entry)
    print(json.dumps({"kernels": line, "batched": ell_rows["batched"]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
