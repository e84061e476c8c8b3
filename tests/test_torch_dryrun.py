"""The port's dry-run (``repro_torch.launch.dryrun``): cells run on a fake
process group of 512 ranks, each in a subprocess of its own (the group
is process-global), and their artifacts are held to what the reference's
test checks (``tests/test_dryrun.py``) and to the reference's own
formulas and specs.

The decode cell runs at 2 layers (``cfg_overrides={"n_layers": 2}``)
to stay fast; the full-depth cells are marked slow, as the reference's
are."""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.models import lm as rlm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESH_SIZES = {"16x16": {"data": 16, "model": 16},
              "2x16x16": {"pod": 2, "data": 16, "model": 16}}
# the reference's keys that only XLA gives: not written by the port
XLA_ONLY = ("xla_cost", "compile_s", "lower_s", "hlo_estimate")
DECODE_ARCH = "rwkv6-1.6b"


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _run(args, timeout=600):
    proc = subprocess.run([sys.executable, *args], env=_env(), cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def _run_cell(out_dir, arch, shape, multi_pod, **kw):
    """``run_cell`` in a process of its own; the artifact's contents."""
    _run(["-c", "from repro_torch.launch import dryrun; "
          f"dryrun.run_cell({arch!r}, {shape!r}, {multi_pod!r}, "
          f"{str(out_dir)!r}, **{kw!r})"])
    mesh = "2x16x16" if multi_pod else "16x16"
    with open(os.path.join(out_dir, f"{arch}_{shape}_{mesh}.json")) as f:
        return json.load(f)


def _check_cell(cell, mesh):
    assert "error" not in cell, cell
    assert cell["mesh"] == mesh
    assert cell["n_chips"] == (256 if mesh == "16x16" else 512)
    assert cell["memory"]["peak_per_device_bytes"] > 0
    assert cell["roofline"]["bottleneck"] in (
        "compute_s", "memory_s", "collective_s")
    assert not [k for k in XLA_ONLY if k in cell]
    consts = cell["roofline"]["constants"]
    assert (consts["peak_flops"], consts["hbm_bw"]) == (989e12, 3.35e12)
    assert "H100" in consts["source"]


def test_dryrun_lp_cell_both_meshes(tmp_path):
    out = str(tmp_path)
    stdout = _run(["-m", "repro_torch.launch.dryrun", "--arch",
                   "lp_crossbar", "--shape", "dist_step", "--mesh", "both",
                   "--out", out])
    assert stdout.count("[OK]") == 2, stdout
    for mesh in ("16x16", "2x16x16"):
        with open(os.path.join(out, f"lp_crossbar_dist_step_{mesh}.json")) \
                as f:
            cell = json.load(f)
        _check_cell(cell, mesh)
        # the step's 64 iterations, two all-reduces each (a GEMV and an
        # all-reduce each way, engine.sharded_operator)
        assert cell["collectives"]["counts"] == {"all-reduce": 128}
        assert cell["collectives"]["total_bytes"] > 0
        assert cell["op_estimate"]["flops"] > 0
        assert cell["model"]["model_flops"] == 2.0 * 2.0 * 96 * 160 * 64


def test_dryrun_unknown_cell_reports_fail(tmp_path):
    stdout = _run(["-m", "repro_torch.launch.dryrun", "--arch", "no-such",
                   "--shape", "train_4k", "--out", str(tmp_path)])
    assert "[FAIL] no-such_train_4k_16x16: KeyError" in stdout, stdout
    with open(os.path.join(tmp_path, "no-such_train_4k_16x16.json")) as f:
        cell = json.load(f)
    assert cell["error"].startswith("KeyError") and "traceback" in cell


@pytest.fixture(scope="module")
def decode_cell(tmp_path_factory):
    """One decode cell on the multi-pod mesh, at 2 layers."""
    out = tmp_path_factory.mktemp("dryrun")
    return _run_cell(out, DECODE_ARCH, "decode_32k", True,
                     cfg_overrides={"n_layers": 2})


def _ref_cfg():
    return dataclasses.replace(ref_get_config(DECODE_ARCH), n_layers=2)


def test_dryrun_decode_cell_multipod(decode_cell):
    _check_cell(decode_cell, "2x16x16")
    assert decode_cell["collectives"]["total_bytes"] > 0
    assert decode_cell["cfg_overrides"] == {"n_layers": 2}


def test_dryrun_model_block_is_the_reference_formulas(decode_cell):
    cfg, shape = _ref_cfg(), REF_SHAPES["decode_32k"]
    tokens = shape.global_batch            # a decode step: one a sequence
    assert decode_cell["model"] == {
        "arch": cfg.name, "shape": "decode_32k", "kind": "decode",
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "tokens_per_step": tokens,
        "model_flops": 2.0 * cfg.active_param_count() * tokens}


def _local_bytes(sds, spec, sizes):
    """Bytes of rank 0's block of an array placed by a PartitionSpec on a
    mesh of ``sizes``: each sharded dimension cut in ceil(n / parts)."""
    n = 1
    for d, size in enumerate(sds.shape):
        axes = spec[d] if d < len(spec) else None
        axes = () if axes is None else (
            (axes,) if isinstance(axes, str) else tuple(axes))
        parts = math.prod(sizes[a] for a in axes if a in sizes)
        n *= -(-size // parts)
    return n * sds.dtype.itemsize


def _tree_bytes(shapes, specs, sizes):
    if isinstance(shapes, dict):
        return sum(_tree_bytes(v, specs[k], sizes) for k, v in shapes.items())
    return _local_bytes(shapes, specs, sizes)


def test_dryrun_argument_bytes_are_the_shards(decode_cell):
    """``memory.argument_bytes`` is the sum of one device's shard of every
    input, computed here from the reference's ``param_shapes``,
    ``partition_specs``, ``init_cache`` and ``cache_specs``."""
    import jax
    from jax.sharding import PartitionSpec as P

    cfg, shape = _ref_cfg(), REF_SHAPES["decode_32k"]
    sizes = MESH_SIZES["2x16x16"]
    dp = ("pod", "data")              # 128 sequences over 32 ranks
    params = _tree_bytes(rlm.param_shapes(cfg),
                         rlm.partition_specs(cfg, mode="fsdp"), sizes)
    cache = _tree_bytes(
        rlm.init_cache(cfg, shape.global_batch, shape.seq_len,
                       as_shapes=True),
        rlm.cache_specs(cfg), sizes)
    tokens = _local_bytes(jax.ShapeDtypeStruct((shape.global_batch, 1),
                                               "int32"), P(dp, None), sizes)
    assert decode_cell["memory"]["argument_bytes"] == params + cache + tokens


@pytest.mark.slow
def test_dryrun_lm_decode_cell_multipod_full_depth(tmp_path):
    cell = _run_cell(tmp_path, "musicgen-large", "decode_32k", True)
    _check_cell(cell, "2x16x16")
    assert cell["collectives"]["total_bytes"] > 0


@pytest.mark.slow
def test_dryrun_lp_256k_cell_both_meshes(tmp_path):
    for multi_pod, mesh in ((False, "16x16"), (True, "2x16x16")):
        cell = _run_cell(tmp_path, "lp_256k", "dist_step", multi_pod)
        _check_cell(cell, mesh)
