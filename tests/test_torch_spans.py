"""The port's spans and counters (``repro_torch.spans``): the records'
nesting, ids and store, when they are recorded, the device seconds, the
idle-by-span join, and the spans the solve, its loop and the serving
layer record on the CPU; on a card, that a CUDA-only profile records
them and that their stamps agree with the profiler's."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core.pdhg import PDHGOptions, solve_jit
from repro_torch.launch.solve import main as solve_cli
from repro_torch.lp import random_standard_lp, sparse_random_standard_lp
from repro_torch.runtime import BatchSolver


def _by_name(recs, name):
    return [r for r in recs if r["name"] == name]


def _open_spans():
    return list(getattr(spans._local, "stack", []))


# ------------------------------------------------------------ records ---

def test_spans_nest_with_parent_and_root_ids():
    with spans.recording():
        with spans.span("a", k=1):
            with spans.span("b"):
                with spans.span("c"):
                    pass
            with spans.span("d"):
                pass
        with spans.span("e"):
            pass
    recs = {r["name"]: r for r in spans.records()}
    a, b, c, d, e = (recs[k] for k in "abcde")
    assert a["parent"] is None and a["root"] == a["id"]
    assert b["parent"] == a["id"] and c["parent"] == b["id"]
    assert d["parent"] == a["id"]
    assert {b["root"], c["root"], d["root"]} == {a["id"]}
    assert e["parent"] is None and e["root"] == e["id"]
    assert len({r["id"] for r in recs.values()}) == 5
    assert a["attrs"] == {"k": 1}
    assert a["start_ns"] <= b["start_ns"] <= c["start_ns"] <= c["end_ns"]
    assert c["end_ns"] <= b["end_ns"] <= d["start_ns"] <= a["end_ns"]
    assert not _open_spans()


def test_each_thread_has_its_own_stack():
    seen = {}

    def worker():
        with spans.span("worker"):
            seen["open"] = [s.name for s in _open_spans()]

    with spans.recording():
        with spans.span("main"):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
    recs = {r["name"]: r for r in spans.records()}
    assert seen["open"] == ["worker"]
    assert recs["worker"]["parent"] is None
    assert recs["worker"]["root"] == recs["worker"]["id"]


def test_the_store_is_bounded_and_counts_its_drops(monkeypatch):
    monkeypatch.setattr(spans, "MAX_RECORDS", 3)
    with spans.recording():
        for i in range(5):
            with spans.span("s", i=i):
                pass
    assert [r["attrs"]["i"] for r in spans.records()] == [0, 1, 2]
    assert spans.counters()["dropped"] == 2


def test_nothing_is_recorded_while_recording_is_off():
    with spans.recording():
        with spans.span("kept"):
            pass
    assert not torch.autograd._profiler_enabled()
    off = spans.span("off", device=torch.device("cpu"))
    assert off is spans.span("other")       # the shared do-nothing span
    with off as s:
        s.set("mode", "eager")
    spans.count("host_reads")
    assert [r["name"] for r in spans.records()] == ["kept"]
    assert spans.counters()["host_reads"] == 0


def test_only_the_latest_stretch_is_kept():
    with spans.recording():
        with spans.span("first"):
            spans.count("host_reads", 3)
    with spans.span("between"):
        pass
    with spans.recording():
        with spans.span("second"):
            spans.count("host_reads")
    assert [r["name"] for r in spans.records()] == ["second"]
    assert spans.counters()["host_reads"] == 1


def test_a_profile_after_recording_is_a_stretch_of_its_own():
    with spans.recording():
        with spans.span("recorded"):
            pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("profiled"):
            pass
    assert [r["name"] for r in spans.records()] == ["profiled"]


def test_a_cpu_profile_records_spans_and_their_ranges():
    with spans.span("before"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("traced"):
            torch.ones(8).add_(1)
    assert [r["name"] for r in spans.records()] == ["traced"]
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "traced" in names


def test_device_seconds_are_the_host_seconds_on_the_cpu():
    with spans.recording():
        with spans.span("d", device=torch.device("cpu")):
            torch.ones(64).sum()
        with spans.span("h"):
            pass
    d, h = spans.records()
    assert d["device_s"] == (d["end_ns"] - d["start_ns"]) / 1e9
    assert h["device_s"] is None


def test_timed_spans_always_time_themselves():
    with spans.timed("t") as t:
        pass
    assert t.seconds is not None and t.seconds >= 0
    with spans.recording():
        with spans.timed("t", k=2) as t:
            pass
    (r,) = spans.records()
    assert t.seconds == (r["end_ns"] - r["start_ns"]) / 1e9
    assert r["attrs"] == {"k": 2}


def test_counters_group_by_key_and_snapshot_the_process_counters():
    with spans.recording():
        spans.count("windows.replay", 2)
        spans.count("stack_bytes.ell", 100)
        spans.count("host_reads")
    c = spans.counters()
    assert c["windows"] == {"replay": 2}
    assert c["stack_bytes"] == {"ell": 100} and c["host_reads"] == 1
    assert set(c["graphs"]) == {"captures", "replays"}
    assert "dual_step" in c["launches"] and "compiles" in c["compiles"]


# -------------------------------------------------------- idle by span ---

def _rec(name, start, end, rid, parent=None):
    return {"name": name, "id": rid, "parent": parent, "root": rid,
            "start_ns": start, "end_ns": end, "attrs": {}, "device_s": None}


def test_idle_goes_to_the_innermost_span_open_at_the_gap():
    recs = [_rec("serve", 0, 100, 1), _rec("serve.stack", 10, 30, 2, 1),
            _rec("serve.upload", 30, 40, 3, 1),
            _rec("loop.read", 60, 70, 4, 1)]
    device = [(40, 50), (55, 58), (70, 90), (85, 95)]
    idle = spans.idle_by_span(device, recs)
    # 0-40: mid 20 in serve.stack; 50-55 and 58-70 in serve, loop.read;
    # 95-100 in serve
    assert idle == pytest.approx({"serve.stack": 40e-9, "serve": 10e-9,
                                  "loop.read": 12e-9})


def test_idle_under_no_span_goes_to_host():
    recs = [_rec("solve", 100, 200, 1), _rec("solve", 300, 400, 2)]
    device = [(0, 50), (90, 110), (190, 310)]
    idle = spans.idle_by_span(device, recs)
    # 50-90 (its middle under none); 110-190 in the first solve; 310-400
    # in the second
    assert idle == pytest.approx({spans.HOST: 40e-9, "solve": 170e-9})
    assert spans.idle_by_span([], []) == {}


# ------------------------------------------------ the instrumented port ---

def test_solve_jit_records_its_spans():
    opts = PDHGOptions(max_iters=20000, tol=1e-6, check_every=64,
                       lanczos_iters=16)
    with spans.recording():
        res = solve_jit(random_standard_lp(12, 20, seed=1), opts,
                        device="cpu")
    recs = spans.records()
    windows = res.iterations // opts.check_every
    (root,) = _by_name(recs, "solve")
    assert root["attrs"] == {"m": 12, "n": 20, "dtype": "float64"}
    for name in ("solve.prepare", "solve.norm", "solve.result"):
        (r,) = _by_name(recs, name)
        assert r["parent"] == root["id"]
    for name in ("loop.window", "loop.check", "loop.read"):
        got = _by_name(recs, name)
        assert len(got) == windows
        assert {r["parent"] for r in got} == {root["id"]}
    assert all(r["device_s"] is not None
               for r in _by_name(recs, "loop.window")
               + _by_name(recs, "loop.check"))
    c = spans.counters()
    assert c["windows"] == {"eager": windows}
    assert c["host_reads"] == windows
    assert not _open_spans()


def _sparse_stream():
    # several ELL buckets: the shapes and the widths differ
    return [sparse_random_standard_lp(32, 64, density=0.15, seed=s)
            for s in (2, 4)] + [sparse_random_standard_lp(
                48, 96, density=0.15, seed=1)]


def _dense_stream():
    return [random_standard_lp(8, 14, seed=0),
            random_standard_lp(20, 34, seed=1)]


@pytest.mark.parametrize("stream,path", [(_sparse_stream, "ell"),
                                         (_dense_stream, "dense")])
def test_solve_stream_records_its_spans_by_bucket(stream, path):
    opts = PDHGOptions(max_iters=2000, tol=1e-4, check_every=64,
                       lanczos_iters=16)
    solver = BatchSolver(opts, torch_device="cpu")
    with spans.recording():
        results = solver.solve_stream(stream())
    recs = spans.records()
    st = solver.last_stream_stats
    n = st["n_buckets"]
    assert n >= 2 and all(r is not None for r in results)
    assert not _open_spans()
    by_id = {r["id"]: r for r in recs}
    (root,) = _by_name(recs, "serve")
    assert root["attrs"] == {"lps": len(results), "buckets": n}
    (group,) = _by_name(recs, "serve.group")
    assert group["parent"] == root["id"]
    stacks = _by_name(recs, "serve.stack")
    assert len(stacks) == len(_by_name(recs, "serve.upload")) == n
    assert {s["attrs"]["path"] for s in stacks} == {path}
    key = "dense" if path == "dense" else "sparse"
    assert sum(s["attrs"]["bytes"] for s in stacks) \
        == st[f"{key}_stack_bytes"] == spans.counters()["stack_bytes"][path]
    # each bucket's loop runs under that bucket's serve.step spans
    windows = {}
    for r in _by_name(recs, "loop.window"):
        step = by_id[r["parent"]]
        assert step["name"] == "serve.step"
        k = step["attrs"]["bucket"]
        windows[k] = windows.get(k, 0) + 1
    assert sorted(windows.values()) == sorted(
        b["windows"] for b in st["bucket_windows"])
    assert len(_by_name(recs, "solve.prepare")) == n
    assert len(_by_name(recs, "solve.norm")) == n
    for name in ("dispatch", "collect"):
        (phase,) = _by_name(recs, f"serve.{name}")
        assert phase["parent"] == root["id"]
        assert st[f"{name}_s"] == (phase["end_ns"]
                                   - phase["start_ns"]) / 1e9


def test_cli_trace_writes_records_and_counters(tmp_path, capsys):
    path = tmp_path / "trace.json"
    solve_cli(["--torch-device", "cpu", "--instance", "rand:8x14",
               "--trace", str(path)])
    assert "trace:" in capsys.readouterr().out
    doc = json.loads(path.read_text())
    names = {r["name"] for r in doc["records"]}
    assert {"solve", "solve.prepare", "solve.norm", "loop.window",
            "loop.check", "loop.read", "solve.result"} <= names
    assert doc["counters"]["host_reads"] == len(
        [r for r in doc["records"] if r["name"] == "loop.read"])
    assert doc["idle_by_span"] is None and doc["device"] == "cpu"
    assert doc["seconds_by_span"]["solve"] > 0


# ------------------------------------------------------------- on a card ---

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA-only profile and CUDA "
                    "events need one")
    return torch.device("cuda")


def _cuda_profile(*more):
    # a span that finds recording off ends the last stretch, so that the
    # profile's records are its own
    with spans.span("off"):
        pass
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA, *more])


def _runtime_calls(prof, name):
    cuda = torch.autograd.DeviceType.CUDA
    return np.array([(e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() != cuda and e.name() == name],
                    np.int64).reshape(-1, 2)


def _inside(calls, rec, slack_ns=50_000):
    """The calls that lie within ``rec``'s stamps, widened by the slack."""
    return calls[(calls[:, 0] >= rec["start_ns"] - slack_ns)
                 & (calls[:, 1] <= rec["end_ns"] + slack_ns)]


@pytest.mark.cuda
def test_a_cuda_only_profile_records_spans(cuda):
    x = torch.ones(1024, device=cuda)
    with _cuda_profile():
        assert torch.autograd._profiler_enabled()
        with spans.span("probe", device=cuda):
            x.add_(1)
    (r,) = spans.records()
    assert r["name"] == "probe" and r["device_s"] > 0


@pytest.mark.cuda
def test_span_stamps_agree_with_the_profiler_clock(cuda):
    """A span around one launch holds the runtime's launch call within
    50 us at both ends (the spans 2 ms apart, so that no other launch
    lies that near)."""
    x = torch.ones(1024, device=cuda)
    x.add_(1)
    torch.cuda.synchronize()
    with _cuda_profile() as prof:
        for _ in range(20):
            with spans.span("probe"):
                x.add_(1)
            torch.cuda.synchronize()
            time.sleep(0.002)
    calls = _runtime_calls(prof, "cudaLaunchKernel")
    recs = spans.records()
    assert len(recs) == 20
    lead, lag = [], []
    for r in recs:
        assert r["end_ns"] - r["start_ns"] < 1_000_000
        (call,) = _inside(calls, r)
        lead.append(int(call[0]) - r["start_ns"])
        lag.append(r["end_ns"] - int(call[1]))
    print(f"launch call after the span's start {np.median(lead)} ns, "
          f"span's end after the call's {np.median(lag)} ns (medians)")


@pytest.mark.cuda
def test_span_stamps_agree_with_their_own_ranges(cuda):
    """Under a profile of the host and the card, each span's stamps lie
    within 50 us of the profiler's own record of its range (the first
    span, which pays for the first range, left out)."""
    x = torch.ones(1024, device=cuda)
    with _cuda_profile(torch.profiler.ProfilerActivity.CPU) as prof:
        for _ in range(21):
            with spans.span("probe"):
                x.add_(1)
    host = torch.autograd.DeviceType.CPU
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "probe" and e.device_type() == host)
    recs = sorted(spans.records(), key=lambda r: r["start_ns"])
    assert len(ranges) == len(recs) == 21
    lead = [r["start_ns"] - s for (s, _), r in zip(ranges, recs)][1:]
    lag = [e - r["end_ns"] for (_, e), r in zip(ranges, recs)][1:]
    assert max(map(abs, lead + lag)) < 50_000, (lead, lag)
    print(f"span's start after its range's {np.median(lead)} ns, range's "
          f"end after the span's {np.median(lag)} ns (medians)")


@pytest.mark.cuda
def test_loop_window_spans_hold_their_launches(cuda):
    """Each replayed or captured window holds its graph's launch, and
    each eager window its step kernels' launches, within 50 us."""
    steps = 16
    opts = PDHGOptions(max_iters=8 * steps, tol=1e-30, check_every=steps,
                       lanczos_iters=16)
    lp = random_standard_lp(64, 128, seed=0)
    solve_jit(lp, opts, device=cuda)
    with _cuda_profile() as prof:
        solve_jit(lp, opts, device=cuda)
    torch.cuda.synchronize()
    graph = _runtime_calls(prof, "cudaGraphLaunch")
    kernel = _runtime_calls(prof, "cudaLaunchKernel")
    windows = _by_name(spans.records(), "loop.window")
    modes = [w["attrs"]["mode"] for w in windows]
    assert modes == ["eager", "capture"] + ["replay"] * 6
    for w in windows:
        if w["attrs"]["mode"] == "eager":
            assert len(_inside(kernel, w)) >= 2 * steps + 1
        else:
            assert len(_inside(graph, w)) == 1
    assert len(graph) == 7
    assert all(w["device_s"] > 0 for w in windows)
