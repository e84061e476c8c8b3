"""Peak parity of the port's dry run with the reference's.

Each case runs one cell at 2 layers (``cfg_overrides={"n_layers": 2}``)
twice at once, each in a process of its own (both dry runs hold a
process-global device set): the port's ``repro_torch.launch.dryrun.
run_cell`` on its fake process group and the reference's
``repro.launch.dryrun.run_cell`` on XLA's 512 host devices.  The port's
peak a device is held to at most ``RATIO`` times XLA's, and the argument
and output bytes to XLA's exactly (both are the shards the specs give;
XLA's outputs add the pointer table of a tuple of buffers).

These are the cells whose port peaks ran 1.5-4.3 times the reference's
before the models gathered the experts' and the head's weights over the
data axes, took the loss's logsumexp over the sharded vocabulary,
projected MLA's latents a rank's heads at a time and sharded the heads
that do not divide "model" after their view (PERF.md, section 7).  The
four fastest run here; the rest are marked slow."""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = 2
RATIO = 1.2
# Counting differences (PERF.md, section 7): bytes of a cell's port peak
# that XLA's count cannot hold by design.  The one named there, MoE's
# one-hot slots materialized for the dispatch product where XLA fuses
# them into the dot, leaves olmoe's prefill at 1.06x the reference's at
# 2 layers, so no cell needs an allowance here.
ALLOWANCE = {}

FAST = [("minicpm3-4b", "decode_32k", False),
        ("rwkv6-1.6b", "train_4k", False),
        ("olmoe-1b-7b", "train_4k", True),
        ("qwen3-14b", "train_4k", False)]
SLOW = [("olmoe-1b-7b", "train_4k", False),
        ("grok-1-314b", "train_4k", False),
        ("grok-1-314b", "train_4k", True),
        ("olmoe-1b-7b", "prefill_32k", False),
        ("minicpm3-4b", "prefill_32k", False),
        ("hymba-1.5b", "prefill_32k", False)]

_RESULTS = {}


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _cell_proc(package, arch, shape, multi_pod, out_dir):
    code = (f"from {package}.launch import dryrun; "
            f"dryrun.run_cell({arch!r}, {shape!r}, {multi_pod!r}, "
            f"{out_dir!r}, cfg_overrides={{'n_layers': {LAYERS}}})")
    return subprocess.Popen([sys.executable, "-c", code], env=_env(),
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _pair(tmp_root, arch, shape, multi_pod):
    """(the port's artifact, the reference's) for one cell, both run at
    once; each cell runs once a session."""
    key = (arch, shape, multi_pod)
    if key not in _RESULTS:
        mesh = "2x16x16" if multi_pod else "16x16"
        dirs = {p: os.path.join(tmp_root, p, f"{arch}_{shape}_{mesh}")
                for p in ("repro_torch", "repro")}
        procs = {p: _cell_proc(p, arch, shape, multi_pod, d)
                 for p, d in dirs.items()}
        cells = {}
        for p, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            assert proc.returncode == 0, (p, out, err[-3000:])
            with open(os.path.join(dirs[p],
                                   f"{arch}_{shape}_{mesh}.json")) as f:
                cells[p] = json.load(f)
            assert "error" not in cells[p], (p, cells[p]["error"])
        _RESULTS[key] = (cells["repro_torch"], cells["repro"])
    return _RESULTS[key]


def _tuple_table(arch, shape):
    """Bytes XLA's ``output_size_in_bytes`` adds to a step's output
    buffers when they are a tuple: its table of 8-byte pointers, one a
    leaf (a train step's parameters, optimizer state and loss; a decode
    step's token, logits and cache; a prefill's logits are one array)."""
    import dataclasses

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models import lm
    from repro_torch.train.train_step import opt_state_shapes

    cfg = dataclasses.replace(get_config(arch), n_layers=LAYERS)
    kind = SHAPES[shape].kind
    if kind == "prefill":
        return 0

    def leaves(tree):
        return sum(leaves(v) for v in tree.values()) \
            if isinstance(tree, dict) else 1
    if kind == "train":
        params = lm.param_shapes(cfg)
        n = leaves(params) + leaves(opt_state_shapes(params)) + 1
    else:
        n = 2 + leaves(lm.init_cache(cfg, 1, 1, as_shapes=True))
    return 8 * n


def _check(tmp_root, arch, shape, multi_pod):
    port, ref = _pair(tmp_root, arch, shape, multi_pod)
    pm, rm = port["memory"], ref["memory"]
    assert pm["argument_bytes"] == rm["argument_bytes"]
    assert pm["output_bytes"] + _tuple_table(arch, shape) \
        == rm["output_bytes"]
    bound = (RATIO * rm["peak_per_device_bytes"]
             + ALLOWANCE.get((arch, shape, multi_pod), 0))
    assert pm["peak_per_device_bytes"] <= bound, (
        f"{arch} {shape}: port peak {pm['peak_per_device_bytes']} bytes "
        f"a device against the reference's {rm['peak_per_device_bytes']}")


def _id(cell):
    return f"{cell[0]}-{cell[1]}-{'2x16x16' if cell[2] else '16x16'}"


@pytest.fixture(scope="module")
def tmp_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("peaks"))


@pytest.mark.parametrize("arch,shape,multi_pod", FAST,
                         ids=[_id(c) for c in FAST])
def test_dryrun_peak_within_the_reference(tmp_root, arch, shape,
                                          multi_pod):
    _check(tmp_root, arch, shape, multi_pod)


@pytest.mark.slow
@pytest.mark.parametrize("arch,shape,multi_pod", SLOW,
                         ids=[_id(c) for c in SLOW])
def test_dryrun_peak_within_the_reference_slow(tmp_root, arch, shape,
                                               multi_pod):
    _check(tmp_root, arch, shape, multi_pod)


@pytest.mark.slow
def test_dryrun_two_pods_hold_less_than_one(tmp_root):
    """olmoe's train cell on two pods reads below its own one-pod peak
    (it read 2.5 times it before the experts' weights were gathered)."""
    two, _ = _pair(tmp_root, "olmoe-1b-7b", "train_4k", True)
    one, _ = _pair(tmp_root, "olmoe-1b-7b", "train_4k", False)
    assert (two["memory"]["peak_per_device_bytes"]
            < one["memory"]["peak_per_device_bytes"])
