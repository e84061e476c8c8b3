"""The crossbar cell ``table1-taox-budget`` (the paper's Table 1 LPs on
TaOx-HfOx crossbars), which is not in BENCHMARK.json: its rate spreads
too widely for a bound while the host launches every noisy step
(PERF.md, section 7).  Its entries for BENCHMARK.json are ``XBAR_BENCH``
below, and its pieces are files as any cell's.

On the CPU: the device block held to the program's device model, the
reference's tier held to the program's programmed blocks, the bytes of
a crossbar step and the judge's tier readings by hand, a whole run of
the tiny cell, traced and not, correct, and each departure from the
crossbar model and each fault planted under the crossbar entry read as
not correct.  On the card: the float32 control over the whole pool at
the cell's own size, and a traced run, each judged as a run judges
it."""
from __future__ import annotations

import dataclasses
import io
import json
import time

import pytest
import torch

import _tiny
from perfbench.harness import lp as lpmod
from perfbench.harness import runner, spec, window
from perfbench.reference import crossbar as xref
from perfbench.reference import pdhg
from perfbench.tools import departures
from perfbench.tools.readings import served
from perfbench.yardstick import generators, xbar_step_bytes
from test_perfbench_faults import FAULTS
from test_perfbench_harness import BENCH, _run

XBAR_CELLS = ["table1-taox-budget"]
XBAR_CONFIGS = ["lp-table1-taox"]


def _metric(name, unit, better, source, layer=None):
    m = {"name": name, "unit": unit, "better": better, "source": source}
    if layer:
        m.update(layer=layer, moves="lp_per_s.xbar")
    return {**m, "workloads": XBAR_CELLS}


# the cell's entries of BENCHMARK.json's lists, the end-to-end rate with
# no bound yet; setup_s is BENCHMARK.json's
XBAR_BENCH = {
    "configs": [{"name": "lp-table1-taox",
                 "file": "perfbench/configs/lp-table1-taox.json",
                 "reduced": []}],
    "workloads": [{"name": "table1-taox-budget", "config": "lp-table1-taox",
                   "traffic": "taox-budget", "chips": 1}],
    "end_to_end": [_metric("lp_per_s.xbar", "lp/s", "higher", "host_clock"),
                   *[m for m in BENCH["end_to_end"]
                     if m["name"] == "setup_s"]],
    "per_layer": [
        _metric("iters_per_lp.xbar", "iter", "lower", "program_counter",
                "solve"),
        _metric("kernel_hbm_share.xbar", "%", "higher", "device_trace",
                "kernels"),
        _metric("idle_share.xbar", "%", "lower", "device_trace", "device"),
        _metric("host_wait_share.xbar", "%", "higher", "program_counter",
                "loop"),
        _metric("check_share.xbar", "%", "lower", "program_counter",
                "loop")],
}
XBAR_FAULTS = sorted(f for f, (_, entries) in FAULTS.items()
                     if "solve_crossbar" in entries)


def _config(name: str) -> dict:
    return json.loads((spec.ROOT / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("config", XBAR_CONFIGS)
def test_device_block_is_the_programs_device_model(config):
    from repro_torch.crossbar.device import DEVICES

    block = _config(config)["device"]
    model = dataclasses.asdict(DEVICES[block["name"]])
    assert {k: model[k] for k in block} == block


@pytest.mark.parametrize("spec_,seed", [
    (("rand", 24, 48, None), 0), (("rand", 40, 88, None), 7),
    (("rand", 50, 110, None), 2**31 + 3), (("table1", 24, 41, "gen-ip002"), 0),
    (("table1", 402, 253, "neos5"), 2**31 + 3)])
@pytest.mark.parametrize("config", XBAR_CONFIGS)
def test_reference_tier_is_the_programs_programmed_blocks(config, spec_,
                                                          seed):
    """The same blocks bit for bit from the same instance and seed (M of
    72 padded to two tiles of 64, 128 filling two, 160 padded to three;
    Table 1's gen-ip002, 89 on two, and neos5, 1057 on 17)."""
    from repro_torch.core.pdhg import PDHGOptions
    from repro_torch.crossbar.device import DEVICES
    from repro_torch.crossbar.energy import Ledger
    from repro_torch.crossbar.solver import program_blocks

    block = _config(config)["device"]
    family, m, n, name = spec_
    inst = generators.make(family, m, n, 5, name=name)
    _, _, _, K_fwd, K_adj, _ = program_blocks(
        lpmod.to_program(inst), PDHGOptions(ruiz_iters=10),
        DEVICES[block["name"]], seed, Ledger(), "cpu")
    Ks = pdhg.prepare(inst, torch.float64, "cpu").op.K
    tier = xref.program(Ks, block, seed)
    assert torch.equal(tier.K_fwd, K_fwd) and torch.equal(tier.K_adj, K_adj)
    # the steps the judge leaves out move the blocks
    for kw in ({"program_error": False}, {"quantize": False}):
        other = xref.program(Ks, block, seed, **kw)
        assert not torch.equal(other.K_fwd, K_fwd)


def test_xbar_step_bytes_by_hand():
    # 3840 x 7680 f64: both programmed blocks, 9 n + 6 m vector values
    assert xbar_step_bytes.step_bytes(3840, 7680, 8) == \
        2 * 235_929_600 + 737_280
    # neos5 in standard form, 402 x 655 f64
    assert xbar_step_bytes.step_bytes(402, 655, 8) == \
        2 * 2_106_480 + (9 * 655 + 6 * 402) * 8


def test_kernel_hbm_share_xbar_by_hand():
    read = spec.load_module(
        spec.ROOT / "metrics" / "kernel_hbm_share.xbar.py", "k").read

    class E:
        pool = [type("I", (), {"shape": (3840, 7680)})()]

    traced = window.Request(0, 0, 1, lpmod.Served([
        lpmod.Answer(0, None, None, 40000, "iteration_limit")]))
    cell = type("C", (), {"config": {"dtype": "float64"}})()
    ctx = runner.Context(cell, E(), [traced], 14.0, 0.0,
                         {"busy_s": 7.4, "window_s": 14.0}, traced)
    least = 40000 * 472_596_480 / 3.35e12
    assert read(ctx) == pytest.approx(100 * least / 7.4)
    ctx.trace = None
    assert read(ctx) is None


@pytest.mark.parametrize("departure", sorted(departures.DEPARTURES))
@pytest.mark.parametrize("cell", XBAR_CELLS)
def test_a_departure_makes_the_crossbar_run_incorrect(tmp_path, monkeypatch,
                                                      cell, departure):
    departures.DEPARTURES[departure](monkeypatch.setattr)
    res = _run(tmp_path, cell, bench=XBAR_BENCH)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] >= 1


@pytest.mark.parametrize("fault", XBAR_FAULTS)
@pytest.mark.parametrize("cell", XBAR_CELLS)
def test_a_fault_makes_the_crossbar_run_incorrect(tmp_path, monkeypatch,
                                                  cell, fault):
    """The faults of ``test_perfbench_faults.py`` planted under the
    crossbar entry."""
    FAULTS[fault][0](monkeypatch)
    res = _run(tmp_path, cell, bench=XBAR_BENCH)
    assert res["correct"] is False, res["checks"]
    assert res["failed"] >= 1


@pytest.mark.parametrize("cell", XBAR_CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_the_tiny_crossbar_cell_runs_whole_and_is_correct(tmp_path, cell,
                                                          traced):
    res = _run(tmp_path, cell, traced, bench=XBAR_BENCH)
    assert res["correct"] is True, res
    assert res["attempted"] >= 1 and res["failed"] == 0
    c = spec.load_cell(cell, XBAR_BENCH)
    # the device trace's metrics need a card
    assert set(res["metrics"]) == {
        m.name for m in (c.per_layer if traced else c.end_to_end)
        if m.source != "device_trace"}


@pytest.mark.parametrize("cell", XBAR_CELLS)
def test_tier_readings_by_hand(cell):
    """``noise`` and ``tier`` on a made-up tier: an answer whose residual
    on its own tier is the step to another tier reads ``tier`` 1 there,
    and ``noise`` is sigma_read ||K x|| over that residual."""
    c = spec.load_cell(cell, XBAR_BENCH)
    inst = generators.make("rand", 4, 8, 3)
    s = pdhg.prepare(inst, torch.float64, "cpu")
    x = torch.linspace(0.5, 1.5, 8, dtype=torch.float64)
    K = s.op.K
    own = K.clone()
    own[:, 0] += 1e-3 * (s.b - K @ x) / x[0]      # K' x = b + 1e-3 r0
    r = own @ x - s.b
    other = own - torch.outer(r, torch.ones(8, dtype=torch.float64)) / 8
    tiers = {"prog": xref.Tier(own, own.T, 64, 64, 12, 32),
             "no_program_error": xref.Tier(other, other.T, 64, 64, 12, 32),
             "no_quantization": xref.Tier(own * 0.5, own.T, 64, 64, 12,
                                          32)}
    out = xref.tier_readings(s, tiers, inst, (x * s.d2).numpy(), 5e-4)
    assert out["tier_no_program_error"] == pytest.approx(1.0)
    assert out["noise"] == pytest.approx(
        5e-4 * float(torch.linalg.vector_norm(K @ x))
        / float(torch.linalg.vector_norm(r)))
    assert out["tier"] == max(out["tier_no_program_error"],
                              out["tier_no_quantization"])
    assert c.checks["tier"]["limit"] < 1.0
    assert xref.tier_readings(s, tiers, inst, None, 5e-4)["noise"] == \
        float("inf")


@pytest.mark.parametrize("dtype,correct", [("float32", False),
                                           ("float64", True)])
@pytest.mark.parametrize("cell", XBAR_CELLS)
def test_crossbar_control_is_not_correct_on_a_tiny_lp(tmp_path, cell, dtype,
                                                      correct):
    """The program's float32 path over the tiny pool, judged as a run
    judges it."""
    c = spec.load_cell(cell, XBAR_BENCH, _tiny.tiny_data(tmp_path))
    entry, out, _ = served(c, torch.device("cpu"), dtype=dtype)
    checks, _ = runner.judge(c, entry, out.answers)
    assert all(v["value"] <= v["limit"] for v in checks.values()) is correct


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the cell runs at its own size "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", XBAR_CELLS)
def test_crossbar_control_is_not_correct_on_the_card(cell):
    """The program's float32 path over the cell's whole pool."""
    dev = _card()
    c = spec.load_cell(cell, XBAR_BENCH)
    entry, out, _ = served(c, dev, dtype="float32")
    checks, failed = runner.judge(c, entry, out.answers)
    assert not all(v["value"] <= v["limit"] for v in checks.values())
    assert failed >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("cell", XBAR_CELLS)
def test_the_crossbar_cell_runs_correct_on_the_card(cell):
    """A short traced run at the cell's own size: one request in the
    window and one traced, judged, with its per-layer metrics."""
    dev = _card()
    c = spec.load_cell(cell, XBAR_BENCH)
    out, err = io.StringIO(), io.StringIO()
    res = runner.run(c, 2**32 + 15, 1.0, True, t_start=time.perf_counter(),
                     device=dev.type, out=out, err=err)
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["iters_per_lp.xbar"]["value"] == \
        c.config["options"]["max_iters"]
    assert 0 < res["metrics"]["kernel_hbm_share.xbar"]["value"] < 100
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
