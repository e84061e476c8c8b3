"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled on first use with ``nvcc``, one
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The library
lands in ``build/repro_torch_kernels/<hash>/`` at the repository root,
where ``<hash>`` covers the sources, every header they include and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused.  ``builds`` counts the ``nvcc`` runs of this process.  A
missing ``nvcc``, a failed build or a failed launch raises: there is no
fallback.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("pdhg_kernels.cu", "crossbar_mvm.cu", "sparse_mvm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "libpdhg_kernels.so"

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_INT = ctypes.c_int
_SIGNATURES = {
    # name: argtypes of the _f32/_f64 pair (pointers, sizes, stream last)
    # vectors, step sizes, out; per-lane length; batch
    "pdhg_dual_update": [_P] * 6 + [_LL, _INT, _P],
    "pdhg_primal_update": [_P] * 10 + [_LL, _INT, _P],
    # the step forms: as above with the running sum after the outputs;
    # the window's schedule: tau, sigma in, schedule, tau, sigma out;
    # batch, steps; gamma
    "pdhg_dual_step": [_P] * 7 + [_LL, _INT, _P],
    "pdhg_primal_step": [_P] * 11 + [_LL, _INT, _P],
    "pdhg_schedule": [_P] * 5 + [_INT, _INT, ctypes.c_double, _P],
    # operands, state, step sizes in/out, sums, schedule scratch, the
    # live-lane mask and list; m, n, batch, steps; gamma
    "pdhg_fused_dense": [_P] * 21 + [_INT] * 4 + [ctypes.c_double, _P],
    # the transpose form: K alone, then as above with the partials'
    # scratch before the mask; its slots, m, n, batch, steps; gamma
    "pdhg_fused_dense_t": [_P] * 21 + [_INT] * 5 + [ctypes.c_double, _P],
    # as above with the two ELL forms (values, columns, row lengths)
    # first and the live-lane mask and list last; m, n, Wf, Wa, batch,
    # steps
    "pdhg_fused_ell": [_P] * 25 + [_INT] * 6 + [ctypes.c_double, _P],
    # G+, G-, v, gain, out; R, C; batch; batch strides of G, v, gain/out
    "crossbar_mvm": [_P] * 5 + [_LL, _LL, _INT] + [_LL] * 3 + [_P],
    # data, cols, row lengths, v, out; m, W, batch; batch strides of
    # data/cols, v, out
    "ell_matvec": [_P] * 5 + [_INT] * 3 + [_LL] * 3 + [_P],
}
# kernels whose registers, local (spill) bytes and resident blocks an SM
# ``kernel_attrs`` reads: (vectorised form, int[3] out), no stream
_ATTRS = ("ell_matvec_attrs", "pdhg_fused_ell_attrs",
          "pdhg_fused_dense_t_attrs")
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)

builds = 0      # nvcc runs of this process (a cache of built libraries
#                 on disk makes a warm process report 0)


class BuildResult(NamedTuple):
    path: Path
    seconds: float      # 0.0 when an existing library was reused
    log: str            # nvcc's output (ptxas statistics with verbose)


def repo_root() -> Path:
    # src/repro_torch/kernels/_build.py -> repository root
    return Path(__file__).resolve().parents[3]


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(home) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the "
                           "repro_torch CUDA kernels cannot be built")
    return nvcc


def included_files() -> tuple:
    """The sources and, transitively, every ``#include "..."`` file
    under ``csrc/`` they name, each once, sources first."""
    seen, todo = [], list(SOURCES)
    while todo:
        name = todo.pop(0)
        if name in seen:
            continue
        seen.append(name)
        for inc in _INCLUDE.findall((CSRC / name).read_bytes()):
            if (CSRC / inc.decode()).exists():
                todo.append(inc.decode())
    return tuple(seen)


def _digest() -> str:
    h = hashlib.sha256()
    for name in included_files():
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> BuildResult:
    """Compile the kernels unless an identical build exists.  With
    ``verbose`` the per-kernel register and shared-memory use that
    ptxas reports is returned in the log (the library is the same)."""
    global builds
    extra = ("-Xptxas", "-v") if verbose else ()
    out_dir = repo_root() / "build" / "repro_torch_kernels" / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return BuildResult(lib, 0.0, "")
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = find_nvcc()
    objs = [out_dir / f".{Path(s).stem}.{tag}.o" for s in SOURCES]
    t0 = time.perf_counter()
    # one nvcc per source, all running at once
    jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
            for cmd in ([nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(o),
                         str(CSRC / s)] for s, o in zip(SOURCES, objs))]
    log, failed = [], []
    for cmd, proc in jobs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}")
    tmp = out_dir / f".{LIB_NAME}.{tag}"
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append(proc.stdout)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{proc.stdout}")
    seconds = time.perf_counter() - t0
    builds += 1
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib)        # atomic: concurrent builders never see half
    return BuildResult(lib, seconds, "".join(log))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with every entry
    point's ``argtypes``/``restype`` declared."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    for name in _ATTRS:
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = [_INT, _P]
            fn.restype = ctypes.c_int
    lib.pdhg_error_string.argtypes = [ctypes.c_int]
    lib.pdhg_error_string.restype = ctypes.c_char_p
    return lib


def _suffix(dtype: torch.dtype) -> str:
    if dtype == torch.float64:
        return "f64"
    if dtype == torch.float32:
        return "f32"
    raise TypeError(f"repro_torch kernels take float32 or float64, "
                    f"got {dtype}")


def check(code: int, what: str) -> None:
    if code != 0:
        msg = library().pdhg_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def launch(name: str, dtype: torch.dtype, *args) -> None:
    """Call ``<name>_<f32|f64>`` on PyTorch's current stream and raise
    on a non-zero ``cudaError_t``."""
    fn = getattr(library(), f"{name}_{_suffix(dtype)}")
    stream = torch.cuda.current_stream().cuda_stream
    check(fn(*args, stream), name)


def kernel_attrs(name: str, dtype: torch.dtype, vectorised: bool) -> dict:
    """Registers a thread, local (spill) bytes a thread and resident
    blocks an SM of kernel ``name`` (B4's ``ell_matvec`` or B5's
    ``pdhg_fused_ell``), in its 16-byte-load form or its scalar one."""
    out = (ctypes.c_int * 3)()
    fn = getattr(library(), f"{name}_attrs_{_suffix(dtype)}")
    check(fn(int(vectorised), ctypes.cast(out, _P)), f"{name}_attrs")
    return {"registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2]}


def dense_t_attrs(dtype: torch.dtype, n: int) -> dict:
    """Registers a thread, local (spill) bytes a thread, resident blocks
    an SM and dynamic shared memory a block of B3's transpose form at
    row length ``n`` on an aligned K, and its variant there: ``ring16``
    (16-byte chunks in shared-memory stages), ``ring`` (one element a
    chunk) or ``wide`` (rows too long for the stages)."""
    out = (ctypes.c_int * 5)()
    fn = getattr(library(), f"pdhg_fused_dense_t_attrs_{_suffix(dtype)}")
    check(fn(int(n), ctypes.cast(out, _P)), "pdhg_fused_dense_t_attrs")
    return {"registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2], "dynamic_smem_bytes": out[3],
            "form": ("wide", "ring", "ring16")[out[4]]}


def pointer(t) -> int | None:
    """A tensor's device address, or None (NULL) for an omitted operand."""
    return None if t is None else t.data_ptr()


def check_cuda_operands(*tensors: torch.Tensor) -> None:
    """Every operand on one CUDA device, in one float dtype, contiguous."""
    first = tensors[0]
    _suffix(first.dtype)
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"kernel operands must be tensors, got "
                            f"{type(t).__name__} (keep step sizes on the "
                            f"device as 0-d tensors)")
        if t.device != first.device or t.device.type != "cuda":
            raise ValueError(f"kernel operands must share one CUDA "
                             f"device; got {t.device} and {first.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"kernel operands must share one dtype; got "
                            f"{t.dtype} and {first.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
