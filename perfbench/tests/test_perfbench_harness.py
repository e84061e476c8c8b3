"""The harness: cells and their pieces found by name, the import check,
the window rule, the metrics' arithmetic, and whole runs of tiny cells
on the CPU."""
from __future__ import annotations

import io
import json
import re

import pytest

import _tiny
from perfbench.harness import lp as lpmod
from perfbench.harness import runner, shares, spec, trace, window

BENCH = _tiny.bench()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_every_piece_of_a_cell_is_found_by_name(cell):
    c = spec.load_cell(cell, BENCH)
    assert c.chips == 1
    assert spec.entry_class(c).__name__ == "Entry"
    assert c.end_to_end and c.per_layer
    assert "setup_s" in [m.name for m in c.end_to_end]
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(c, m))
    assert c.checks and all("limit" in v for v in c.checks.values())


def test_benchmark_json_keeps_to_its_format():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in CELLS
    for c in BENCH["configs"]:
        assert (_tiny.REPO / c["file"]).is_file()
        assert json.loads((_tiny.REPO / c["file"]).read_text())[
            "reduced"] == c["reduced"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.core.pdhg", "numpy"], []),
    (["repro", "repro.core"], ["repro"]),
    (["jax._src.core"], ["jax"]),
    (["jaxlib.xla_client", "flax.linen"], ["flax", "jaxlib"]),
    (["reprox", "jaxtyping", "benchmarks.bench_guard"], ["benchmarks"]),
])
def test_import_check_compares_whole_top_level_names(names, found):
    assert runner.forbidden_modules(names) == found


def _clock(durations):
    """A fake clock whose requests take ``durations`` seconds in turn."""
    t = [0.0]
    it = iter(durations)

    def clock():
        return t[0]

    def request(k):
        t[0] += next(it)
        return k

    return clock, request


@pytest.mark.parametrize("durations,seconds,count", [
    ([3.0] * 10, 10.0, 3),        # 3 + 3 + 3, a fourth would end at 12
    ([3.0] * 10, 12.0, 4),        # a fourth ends exactly at the limit
    ([25.0] * 5, 10.0, 1),        # the first request always runs
    ([1.0, 1.0, 6.0, 1.0], 9.0, 3),  # the last request's pace decides
])
def test_window_runs_whole_requests_inside_the_seconds(durations, seconds,
                                                       count):
    clock, request = _clock(durations)
    done, total = window.run_window(request, seconds, clock)
    assert [r.k for r in done] == list(range(count))
    assert total == sum(durations[:count])


def _served(iterations, windows, lanes):
    answers = [lpmod.Answer(i, None, None, it, "optimal")
               for i, it in enumerate(iterations)]
    info = {"check_every": 100, "bucket_windows": [
        {"bucket": None, "lanes": n, "windows": w}
        for n, w in zip(lanes, windows)]}
    return lpmod.Served(answers, info)


def test_lane_useful_share_by_hand():
    from perfbench.harness.spec import load_module, ROOT

    read = load_module(ROOT / "metrics" / "lane_useful_share.stream.py",
                       "l").read
    # bucket A: 3 lanes stopping at 100, 200, 400 (4 windows); bucket B:
    # 1 lane of 300 (3 windows); twice
    reqs = [window.Request(k, 0, 1, _served([100, 200, 400, 300], [4, 3],
                                            [3, 1])) for k in range(2)]
    ctx = runner.Context(None, None, reqs, 2.0, 0.0, None, None)
    assert read(ctx) == pytest.approx(100.0 * 2000 / (2 * 1500))


class _Inst:
    def __init__(self, shape, K):
        self.shape, self.K = shape, K


def test_hbm_and_idle_shares_by_hand():
    from perfbench.yardstick import generators

    class E:
        pool = [_Inst((3840, 7680), None),
                _Inst((16384, 32768),
                      generators.COO([0.0] * 536_871, [0] * 536_871,
                                     [0] * 536_871, (16384, 32768)))]

    traced = window.Request(0, 0, 1, lpmod.Served([
        lpmod.Answer(0, None, None, 1000, "optimal"),
        lpmod.Answer(1, None, None, 2000, "optimal")]))
    cell = type("C", (), {"config": {"dtype": "float64"}})()
    # two untraced requests of the window in 1.6 s: a pace of 0.8 s
    ctx = runner.Context(cell, E(), [traced, traced], 1.6, 0.0,
                         {"busy_s": 0.5, "window_s": 0.9}, traced)
    least = (1000 * 236_666_880 + 2000 * 9_588_180) / 3.35e12
    assert shares.hbm_share(ctx) == pytest.approx(100 * least / 0.5)
    assert shares.idle_share(ctx) == pytest.approx(100 * (1 - 0.5 / 0.8))
    ctx.trace = None
    assert shares.hbm_share(ctx) is None and shares.idle_share(ctx) is None


def test_trace_summary_by_hand():
    host = [(0, 6, "cudaMemcpyAsync"), (36, 44, "cudaStreamSynchronize"),
            (38, 42, "cudaEventQuery"), (95, 110, "cudaGraphLaunch")]
    device = [(10, 30, "dgemv"), (20, 35, "dgemv"), (50, 55, "step"),
              (2, 5, "memcpy HtoD"), (90, 100, "step")]
    s = trace.summarize(device, host, 200e-9)
    assert s["window_s"] == pytest.approx(200e-9)
    # union: [2, 5], [10, 35], [50, 55], [90, 100]; span [0, 110]
    assert s["busy_s"] == pytest.approx(43e-9)
    assert s["device_ops"][0] == ["dgemv", pytest.approx(35e-9)]
    # gaps: [55, 90] host, [35, 50] in the event query, [100, 110] in
    # the graph launch, [5, 10] host, [0, 2] in the copy
    gaps = s["idle_gaps"]
    assert [g[0] for g in gaps] == [
        "host at 0.000 s", "cudaEventQuery at 0.000 s",
        "cudaGraphLaunch at 0.000 s", "host at 0.000 s",
        "cudaMemcpyAsync at 0.000 s"]
    assert [g[1] for g in gaps] == pytest.approx(
        [35e-9, 15e-9, 10e-9, 5e-9, 2e-9])
    assert trace.summarize([], host, 1.0) is None


def _run(tmp_path, cell, traced=False, options=None, seconds=0.1):
    data = _tiny.tiny_data(tmp_path, options)
    c = spec.load_cell(cell, BENCH, data)
    out, err = io.StringIO(), io.StringIO()
    res = runner.run(c, 2**31 + 11, seconds, traced, t_start=0.0,
                     device="cpu", out=out, err=err)
    line = out.getvalue().strip().splitlines()[-1]
    assert json.loads(line) == json.loads(json.dumps(res))
    assert list(res)[-1] == "checks"
    tail = err.getvalue().strip().splitlines()[-len(res["checks"]):]
    assert all(t.startswith("check ") for t in tail)
    return res


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_cell_runs_whole_and_is_correct(tmp_path, cell, traced):
    res = _run(tmp_path, cell, traced)
    assert res["correct"] is True, res
    assert res["attempted"] >= 1 and res["failed"] == 0
    c = spec.load_cell(cell, BENCH)
    want = {m.name for m in (c.per_layer if traced else c.end_to_end)}
    # the device trace's metrics need a card
    got = set(res["metrics"])
    assert got <= want
    assert got == {m.name for m in (c.per_layer if traced
                                    else c.end_to_end)
                   if m.source != "device_trace"}
    assert res["device"]["count"] == 1


def test_a_run_with_jax_loaded_prints_no_result(tmp_path, monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    data = _tiny.tiny_data(tmp_path)
    c = spec.load_cell(CELLS[0], BENCH, data)
    out = io.StringIO()
    with pytest.raises(runner.NoResult) as e:
        runner.run(c, 5, 0.1, False, t_start=0.0, device="cpu", out=out,
                   err=io.StringIO())
    assert e.value.code == 3 and "jax" in str(e.value)
    assert out.getvalue() == ""
