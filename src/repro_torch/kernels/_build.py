"""Build and load the port's CUDA kernels.

The sources under ``csrc/`` are compiled on first use with ``nvcc``, one
process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The library
lands in ``build/repro_torch_kernels/<hash>/`` at the repository root,
where ``<hash>`` covers the sources and the flags, so an edited source
is rebuilt and an unchanged one is reused.  A missing ``nvcc``, a failed
build or a failed launch raises: there is no fallback.  Nothing here
runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("pdhg_kernels.cu", "crossbar_mvm.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "libpdhg_kernels.so"

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    # name: argtypes of the _f32/_f64 pair (pointers, sizes, stream last)
    "pdhg_dual_update": [_P] * 6 + [_LL, _P],
    "pdhg_primal_update": [_P] * 10 + [_LL, _P],
    "pdhg_fused_dense": ([_P] * 18 + [ctypes.c_int] * 3
                         + [ctypes.c_double, _P]),
    # G+, G-, v, gain, out; R, C; batch; batch strides of G, v, gain/out
    "crossbar_mvm": [_P] * 5 + [_LL, _LL, ctypes.c_int] + [_LL] * 3 + [_P],
}


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


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> BuildResult:
    """Compile the kernels unless an identical build exists.  With
    ``verbose`` the per-kernel register and shared-memory use that
    ptxas reports is returned in the log (the library is the same)."""
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
