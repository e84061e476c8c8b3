"""The port's public surface against the reference's.

For each module of ``repro_torch`` that has a counterpart in ``repro``:
every name of the reference's ``__all__`` exists in the port, and every
public function the reference module defines exists in the port with
the same parameters in the same ``inspect.signature`` order.  The
differences that are by design are listed below, each with its reason;
a listed difference that no module shows any more fails the last test,
so the lists stay exact.  Then the calls shaped like the reference's
that once failed in the port.
"""
import ast
import importlib
import inspect
import pathlib
import pkgutil
import types

import numpy as np
import pytest
import torch
from _torch_parity import reference

import repro_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
# parameters the reference takes and the port does not
REF_ONLY = {
    "key": "a JAX PRNG key: the port draws from torch.Generator objects "
           "or seeds, and parity tests inject the reference's draws",
    "k1": "pdhg_step's read-noise keys (PRNG)",
    "k2": "pdhg_step's read-noise keys (PRNG)",
    "noise_keys": "per-MVM read-noise keys of lanczos_svd (PRNG)",
    "interpret": "Pallas interpret mode: a port wrapper takes its plain "
                 "version for CPU tensors and its kernel for CUDA ones",
    "use_pallas": "the Pallas switch of the ELL product (as interpret)",
    "norm_seeded": "the reference compiles a seeded twin of each bucket "
                   "pipeline; the port's pipeline takes rho_seeds at run "
                   "time, one object for both",
}

# parameters the port takes and the reference does not
PORT_ONLY = {
    "generator": "the torch.Generator that replaces a PRNG key",
    "seed": "a seed that replaces a PRNG key",
    "v0": "the norm estimate's start vector, injected for parity",
    "x0": "the start iterate, injected for parity",
    "y0": "the start iterate, injected for parity",
    "draws": "injected draws (interop.Draws) for parity",
    "program_draw": "injected programming-error draws for parity",
    "device": "the torch device to run on (the card unless told)",
    "torch_device": "the torch device where ``device`` is the crossbar "
                    "model",
    "dtype": "the torch dtype of a result built on the host",
    "batch": "lanes of a batched norm estimate (the reference vmaps)",
    "read": "the loop's one host read a window (sanitize.host_read under "
            "the transfer guard)",
    "graph": "the engine's switch that runs the stepped windows without "
             "their CUDA graph, for tests that compare the two",
    "row_len": "ELL row lengths: B4 stops each row at its last slot",
    "row_len_f": "ELL row lengths of the forward form (B4/B5)",
    "row_len_a": "ELL row lengths of the adjoint form (B4/B5)",
    "active": "the loop's live-lane mask: the megakernels skip stopped "
              "lanes",
    "backend": "the torch.distributed backend (nccl or gloo) of the "
               "process group init_cluster makes",
}

# names of the reference that the port does not have
MISSING = {
    ("core", "JNP_UPDATES"): "its port is engine.TORCH_UPDATES (the "
                             "backend is named 'torch')",
    ("kernels", "interpret"): "Pallas interpret mode",
    ("kernels", "interpret_default"): "Pallas interpret mode",
    ("kernels", "ops"): "the reference's wrappers over Pallas calls: the "
                        "port's wrappers are its kernel modules",
    ("kernels", "ref"): "the reference's oracles: each port kernel module "
                        "keeps its plain version beside the kernel",
    ("kernels.sparse_mvm", "ell_matvec_ref"): "its port is "
                                              "ell_matvec_plain",
    ("runtime.sanitize", "install"): "JAX's transfer guard; the port's "
                                     "guard is torch's sync debug mode",
    ("runtime.sanitize", "supported"): "JAX's transfer guard (as install)",
}
# runtime.compat shims JAX versions only: the port's meshes, and its
# counterparts of use_mesh, batch_axes and constrain (which the dry run
# installs for DTensors), are runtime.mesh's, and the package does not
# export them
RUNTIME_COMPAT = ("batch_axes", "compat", "constrain", "get_abstract_mesh",
                  "set_mesh", "shard_map", "use_mesh")
MISSING.update({("runtime", n): "runtime.compat (JAX only)"
                for n in RUNTIME_COMPAT})

# the port's own modules, with no counterpart in the reference
# (models.scan: the reference's scans are lax.scan, the port's a loop the
# dry run counts from its trips; spans: the reference has no spans)
PORT_OWN = ("_device", "interop", "kernels._build", "models.scan",
            "spans")
# reference modules read from their source, never imported here:
# importing repro.launch.dryrun asks XLA for 512 CPU devices
# (runtime.compat.request_cpu_devices), which a test process must not do
FROM_SOURCE = {"launch.dryrun": "src/repro/launch/dryrun.py"}
SHORT = [n[len("repro_torch."):] if "." in n else ""
         for n in sorted(["repro_torch"] + [m.name for m in
                          pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")])]


def _from_source(short):
    """A stand-in for reference module ``short`` built from its source:
    each top-level function with its parameters (defaults replaced by
    None, bodies by ``pass``), and its ``__all__`` if it has one."""
    name = "repro." + short
    tree = ast.parse((ROOT / FROM_SOURCE[short]).read_text())
    mod = types.ModuleType(name)
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            args = node.args
            args.defaults = [ast.Constant(None) for _ in args.defaults]
            args.kw_defaults = [None if d is None else ast.Constant(None)
                                for d in args.kw_defaults]
            for a in (args.posonlyargs + args.args + args.kwonlyargs
                      + [v for v in (args.vararg, args.kwarg) if v]):
                a.annotation = None
            stub = ast.FunctionDef(name=node.name, args=args,
                                   body=[ast.Pass()], decorator_list=[],
                                   returns=None, type_params=[])
            code = ast.fix_missing_locations(ast.Module([stub], []))
            exec(compile(code, FROM_SOURCE[short], "exec"), mod.__dict__)
            mod.__dict__[node.name].__module__ = name
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and getattr(node.targets[0], "id", None) == "__all__"):
            mod.__all__ = ast.literal_eval(node.value)
    return mod


def _modules(short):
    suffix = "." + short if short else ""
    ref = (_from_source(short) if short in FROM_SOURCE
           else importlib.import_module("repro" + suffix))
    return ref, importlib.import_module("repro_torch" + suffix)


def _pairs():
    """(short name, reference module, port module) of every port module
    with a reference counterpart."""
    reference()
    return [(short, *_modules(short)) for short in SHORT
            if short not in PORT_OWN]


def _missing_exports(short, ref, port):
    return [n for n in getattr(ref, "__all__", ()) if not hasattr(port, n)]


def _functions(ref):
    return {n: f for n, f in vars(ref).items()
            if not n.startswith("_") and inspect.isfunction(f)
            and f.__module__ == ref.__name__}


def _signature_gaps(short, ref, port):
    """(missing functions, [(function, ref params, port params)] whose
    orders differ once the listed differences are dropped, ref-only and
    port-only parameters seen)."""
    missing, wrong, seen_ref, seen_port = [], [], set(), set()
    for n, f in _functions(ref).items():
        if not hasattr(port, n):
            missing.append(n)
            continue
        pr = list(inspect.signature(f).parameters)
        pp = list(inspect.signature(getattr(port, n)).parameters)
        seen_ref.update(p for p in pr if p not in pp)
        seen_port.update(p for p in pp if p not in pr)
        kr = [p for p in pr if p in pp or p not in REF_ONLY]
        kp = [p for p in pp if p in pr or p not in PORT_ONLY]
        if kr != kp:
            wrong.append((n, pr, pp))
    return missing, wrong, seen_ref, seen_port


def _pair(short):
    reference()
    return (short, *_modules(short))


PORTED = [s for s in SHORT if s not in PORT_OWN]
IDS = [s or "repro_torch" for s in PORTED]


@pytest.mark.parametrize("short", PORTED, ids=IDS)
def test_every_reference_export_exists(short):
    pair = _pair(short)
    missing = [n for n in _missing_exports(*pair)
               if (short, n) not in MISSING]
    assert missing == [], f"repro_torch.{short} lacks {missing}"


@pytest.mark.parametrize("short", PORTED, ids=IDS)
def test_public_functions_take_the_reference_parameters(short):
    missing, wrong, seen_ref, seen_port = _signature_gaps(*_pair(short))
    assert [n for n in missing if (short, n) not in MISSING] == []
    assert wrong == []
    assert seen_ref <= set(REF_ONLY), seen_ref - set(REF_ONLY)
    assert seen_port <= set(PORT_ONLY), seen_port - set(PORT_ONLY)


def test_every_listed_difference_is_still_needed():
    reference()
    for short in PORT_OWN:
        with pytest.raises(ModuleNotFoundError):
            _modules(short)
    seen_ref, seen_port, seen_missing = set(), set(), set()
    for short, ref, port in _pairs():
        seen_missing.update((short, n) for n in _missing_exports(
            short, ref, port))
        missing, _, r, p = _signature_gaps(short, ref, port)
        seen_missing.update((short, n) for n in missing)
        seen_ref |= r
        seen_port |= p
    assert set(REF_ONLY) - seen_ref == set()
    assert set(PORT_ONLY) - seen_port == set()
    assert set(MISSING) - seen_missing == set()


# ------------------------------------------ calls shaped like the reference's

def test_reference_shaped_calls():
    from repro_torch.core import engine
    from repro_torch.crossbar import encode_core
    from repro_torch.lp import (
        crossbar_sized_lp,
        infeasible_lp,
        netlib_like,
        random_inequality_lp,
        random_inequality_lp_known,
    )

    assert engine.refine_window_factor(2) == 3
    assert engine.refine_window_factor(0) == 1
    lp = infeasible_lp()
    assert lp.K.shape == (8, 12)
    for make in (crossbar_sized_lp, netlib_like, random_inequality_lp,
                 random_inequality_lp_known):
        assert make.__module__ == "repro_torch.lp.generators"
    W = torch.as_tensor(np.random.default_rng(0).normal(size=(8, 8)))
    for how in ("median", "mean"):
        g_pos, g_neg, _, _ = encode_core(
            W, torch.Generator().manual_seed(0), 256, 0.01, ecc=3,
            ecc_decode=how)
        assert g_pos.shape == g_neg.shape == W.shape


@pytest.mark.parametrize("transfer_sanitize", [False, True])
def test_solve_jit_takes_transfer_sanitize(transfer_sanitize):
    from repro_torch.core.pdhg import PDHGOptions, solve_jit
    from repro_torch.lp import random_standard_lp

    lp = random_standard_lp(6, 10, seed=1)
    opts = PDHGOptions(max_iters=2000, check_every=32)
    res = solve_jit(lp, opts, None, None, 0.0, transfer_sanitize,
                    device="cpu")
    plain = solve_jit(lp, opts, device="cpu")
    assert res.iterations == plain.iterations
    assert np.array_equal(res.x, plain.x)
