"""The port's dry-run (``repro_torch.launch.dryrun``): cells run on a fake
process group of 512 ranks, each in a subprocess of its own (the group
is process-global), and their artifacts are held to what the reference's
test checks (``tests/test_dryrun.py``) and to the reference's own
formulas and specs.

The decode cell runs at 2 layers (``cfg_overrides={"n_layers": 2}``)
to stay fast; the full-depth cells are marked slow, as the reference's
are.  One cell a fault class that DTensor could not run before the
models constrained their activations (the microbatch split, head counts
that do not divide the model axis, the MoE dispatch, the token scan)
runs at 2 layers too, its argument bytes held to the reference's
shards."""
import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch

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


def _run_cell(out_dir, arch, shape, multi_pod, seq_len=None,
              unrolled=False, **kw):
    """``run_cell`` in a process of its own; the artifact's contents.
    ``seq_len`` shortens the shape's sequence; ``unrolled`` runs the
    token scans as their loops of trips, not counted from one."""
    setup = ""
    if seq_len is not None:
        setup += ("import dataclasses; dryrun.SHAPES[{0!r}] = "
                  "dataclasses.replace(dryrun.SHAPES[{0!r}], seq_len={1}); "
                  ).format(shape, seq_len)
    if unrolled:
        setup += ("import contextlib; from repro_torch.models import scan; "
                  "scan.counted_scans = "
                  "lambda counter: contextlib.nullcontext(); ")
    _run(["-c", "from repro_torch.launch import dryrun; " + setup +
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


# ------------------------------------------- the cells DTensor once refused

def _ref_bytes(arch, shape_name, mesh, seq_len=None):
    """One device's shard of every input of a cell, from the reference's
    shapes and specs: parameters (fsdp), the AdamW state and the batch
    of a train cell (``microbatch`` does not change what a rank holds),
    the tokens of a prefill cell, tokens and cache of a decode cell."""
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.train.train_step import TrainConfig as RefTrainConfig
    from repro.train.train_step import opt_state_shapes

    cfg = dataclasses.replace(ref_get_config(arch), n_layers=2)
    shape = REF_SHAPES[shape_name]
    batch, seq = shape.global_batch, seq_len or shape.seq_len
    sizes = MESH_SIZES[mesh]
    dp = tuple(a for a in ("pod", "data") if a in sizes)
    pshapes = rlm.param_shapes(cfg)
    pspecs = rlm.partition_specs(cfg, mode="fsdp")
    total = _tree_bytes(pshapes, pspecs, sizes)
    tok = jax.ShapeDtypeStruct((batch, seq if shape.kind != "decode"
                                else 1), "int32")
    if shape.kind == "train":
        total += _tree_bytes(opt_state_shapes(pshapes, RefTrainConfig()),
                             {"m": pspecs, "v": pspecs, "step": P()}, sizes)
        total += 2 * _local_bytes(tok, P(dp, None), sizes)
    elif shape.kind == "prefill":
        total += _local_bytes(tok, P(dp, None), sizes)
    else:
        total += _tree_bytes(rlm.init_cache(cfg, batch, seq, as_shapes=True),
                             rlm.cache_specs(cfg), sizes)
        total += _local_bytes(tok, P(dp, None), sizes)
    return total


# (arch, shape, fault class): the microbatch split (C6), heads that do
# not divide the 16-way model axis (C7: 8 kv heads; 40 heads), the MoE
# dispatch's flatten of 20 capacity slots over 16 ranks (C8)
FAULT_CELLS = [("starcoder2-3b", "train_4k", "C6"),
               ("granite-3-8b", "decode_32k", "C7"),
               ("qwen3-14b", "decode_32k", "C7"),
               ("olmoe-1b-7b", "decode_32k", "C8")]


@pytest.mark.parametrize("arch,shape,fault", FAULT_CELLS,
                         ids=[f"{a}-{s}" for a, s, _ in FAULT_CELLS])
def test_dryrun_cell_that_dtensor_refused_runs(tmp_path, arch, shape, fault):
    cell = _run_cell(tmp_path, arch, shape, False,
                     cfg_overrides={"n_layers": 2})
    _check_cell(cell, "16x16")
    assert cell["memory"]["argument_bytes"] == _ref_bytes(arch, shape,
                                                          "16x16")
    assert cell["collectives"]["total_bytes"] > 0
    if shape == "decode_32k":
        assert cell["memory"]["peak_per_device_bytes"] < 16 * 2**30


SCAN_SEQ = 64     # prefill_32k's scan cut to 64 tokens


@pytest.fixture(scope="module")
def scan_cells(tmp_path_factory):
    """rwkv6-1.6b prefill at 2 layers and SCAN_SEQ tokens: the token scan
    counted from its body, and the same cell with the scan unrolled."""
    out = tmp_path_factory.mktemp("scan")
    kw = dict(seq_len=SCAN_SEQ, cfg_overrides={"n_layers": 2})
    scaled = _run_cell(out / "scaled", "rwkv6-1.6b", "prefill_32k", False,
                       **kw)
    unrolled = _run_cell(out / "unrolled", "rwkv6-1.6b", "prefill_32k",
                         False, unrolled=True, **kw)
    return scaled, unrolled


def test_dryrun_scaled_scan_cell(scan_cells):
    cell = scan_cells[0]
    _check_cell(cell, "16x16")
    assert cell["memory"]["argument_bytes"] == _ref_bytes(
        "rwkv6-1.6b", "prefill_32k", "16x16", seq_len=SCAN_SEQ)


def test_dryrun_scaled_scan_counts_equal_the_unrolled_loop(scan_cells):
    scaled, unrolled = scan_cells
    for key in ("op_estimate", "collectives", "memory", "roofline"):
        assert scaled[key] == unrolled[key], key


HYMBA_SEQ = 512  # prefill_32k's chunked SSM scan cut to 4 chunks of 128


@pytest.fixture(scope="module")
def hymba_scan_cells(tmp_path_factory):
    """hymba-1.5b prefill at 2 layers and HYMBA_SEQ tokens: the chunked
    SSM's loop over chunks counted from its body, and the same cell with
    the loop unrolled."""
    out = tmp_path_factory.mktemp("hymba_scan")
    kw = dict(seq_len=HYMBA_SEQ, cfg_overrides={"n_layers": 2})
    scaled = _run_cell(out / "scaled", "hymba-1.5b", "prefill_32k", False,
                       **kw)
    unrolled = _run_cell(out / "unrolled", "hymba-1.5b", "prefill_32k",
                         False, unrolled=True, **kw)
    return scaled, unrolled


def test_dryrun_scaled_chunk_scan_counts_equal_the_unrolled_loop(
        hymba_scan_cells):
    scaled, unrolled = hymba_scan_cells
    _check_cell(scaled, "16x16")
    assert scaled["memory"]["argument_bytes"] == _ref_bytes(
        "hymba-1.5b", "prefill_32k", "16x16", seq_len=HYMBA_SEQ)
    for key in ("op_estimate", "collectives", "memory", "roofline"):
        assert scaled[key] == unrolled[key], key


# each correction of launch.dryrun._as_deployed, and how a torch without
# its hook is made (DTensor itself runs on: the module that calls the
# all-to-all keeps its own name for it; the propagator's cache keeps the
# bound method it wraps)
MISSING_HOOKS = {
    "shard_dim_alltoall": (
        "from torch.distributed.tensor import _collective_utils; "
        "del _collective_utils.shard_dim_alltoall; "),
    "propagate_op_sharding_non_cached": (
        "from torch.distributed.tensor._sharding_prop import "
        "ShardingPropagator; "
        "del ShardingPropagator.propagate_op_sharding_non_cached; "),
}


@pytest.mark.parametrize("hook", sorted(MISSING_HOOKS))
def test_dryrun_without_a_correction_hook_reports_fail(tmp_path, hook):
    """A torch without a hook that ``_as_deployed`` replaces gets no
    counts: the cell reports FAIL, naming the torch and the hook."""
    stdout = _run(["-c", MISSING_HOOKS[hook] +
                   "from repro_torch.launch import dryrun; "
                   f"dryrun.run_cell({DECODE_ARCH!r}, 'decode_32k', False, "
                   f"{str(tmp_path)!r}, cfg_overrides={{'n_layers': 2}})"])
    assert "[FAIL]" in stdout and hook in stdout, stdout
    with open(os.path.join(tmp_path, f"{DECODE_ARCH}_decode_32k_16x16.json"))\
            as f:
        cell = json.load(f)
    assert cell["error"].startswith("RuntimeError")
    assert hook in cell["error"] and torch.__version__ in cell["error"]
    assert not {"memory", "op_estimate", "collectives"} & set(cell)


def test_constrain_returns_a_plain_tensor_itself():
    from repro_torch.models.lm import constrain_tokens
    from repro_torch.runtime.mesh import constrain, make_mesh, use_mesh

    x = torch.ones(4, 3, 2)
    assert constrain(x, ("pod", "data"), None, "model") is x
    assert constrain_tokens(x) is x
    with use_mesh(make_mesh({"data": 1, "model": 1}, device="cpu")):
        assert constrain(x, ("pod", "data"), None, "model") is x
        assert constrain_tokens(x) is x


@pytest.mark.slow
def test_dryrun_reference_decode_cell_full_depth(tmp_path):
    """The reference's own decode cell (``tests/test_dryrun.py``), whole."""
    cell = _run_cell(tmp_path, "starcoder2-3b", "decode_32k", True)
    _check_cell(cell, "2x16x16")
    assert cell["collectives"]["total_bytes"] > 0
    # fits a 16 GiB HBM budget
    assert cell["memory"]["peak_per_device_bytes"] < 16 * 2**30
