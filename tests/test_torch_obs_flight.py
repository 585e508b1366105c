"""The port's flight recorder (``obs/flight.py``), stuck-cycle monitor
(``scheduler/monitor.py``) and device observatory (``obs/device.py``),
with the pipelined loop's trace, on the CPU.

The flight, monitor and trace cases of the reference's
``tests/test_obs.py`` run against the port's own ``TRACER``, ``FLIGHT``
and ``DEVICE_OBS`` (reset between cases): the fencing-abort,
deferred-pipeline-error and manual triggers, the rate limit and the disk
cap, the monitor counting each stuck mark once across monitors, failed
rounds and publishes closing their marks, the pipelined trace export
(the prestage crossing the in-flight solve on another track) and the
pipelined loop placing the same with tracing on and off. Then the
observatory on the CPU: a window over K rounds writes one trace holding
the solve's annotations, ``annotate`` is a no-op outside a window, the
rate limit and the disk cap hold, ``reset()`` stops an open window, a
window changes no placement, the staged cache is a live-bytes owner, and
a build is recorded while a load is not."""

import importlib
import json
import os
import time

import numpy as np
import pytest
import torch

from test_torch_colocation import PORT

CPU, MEM = 0, 1

flight_mod = importlib.import_module("koordinator_tpu_torch.obs.flight")
device_mod = importlib.import_module("koordinator_tpu_torch.obs.device")
trace_mod = importlib.import_module("koordinator_tpu_torch.obs.trace")
monitor_mod = importlib.import_module("koordinator_tpu_torch.scheduler.monitor")
components = importlib.import_module("koordinator_tpu_torch.metrics.components")
cmd = importlib.import_module("koordinator_tpu_torch.cmd.scheduler")
bk = importlib.import_module("koordinator_tpu_torch.ops.binpack_kernel")
TickPipeline = importlib.import_module(
    "koordinator_tpu_torch.scheduler.pipeline").TickPipeline
FLIGHT, DEVICE_OBS, TRACER = (flight_mod.FLIGHT, device_mod.DEVICE_OBS,
                              trace_mod.TRACER)
FencingError = PORT.le.FencingError


@pytest.fixture(autouse=True)
def _fresh_obs():
    TRACER.clear()
    TRACER.set_enabled(True)
    DEVICE_OBS.reset()
    yield
    TRACER.clear()
    TRACER.set_enabled(True)
    DEVICE_OBS.reset()
    DEVICE_OBS.configure(profile_dir=device_mod._default_profile_dir(),
                         profile_min_interval_s=30.0, profile_max_windows=8)


@pytest.fixture
def flight_dir(tmp_path):
    FLIGHT.reset()
    FLIGHT.configure(dump_dir=str(tmp_path), min_interval_s=0.0)
    yield tmp_path
    FLIGHT.reset()
    FLIGHT.configure(dump_dir=flight_mod._default_dump_dir(),
                     min_interval_s=1.0)


def _wired(n_nodes=8):
    bus = PORT.bus()
    sched = PORT.scheduler()
    PORT.wiring.wire_scheduler(bus, sched)
    for i in range(n_nodes):
        bus.apply(PORT.Kind.NODE, f"n{i}", PORT.node(f"n{i}", cpu=64000,
                                                     mem=131072))
        bus.apply(PORT.Kind.NODE_METRIC, f"n{i}", PORT.metric(
            f"n{i}", usage={CPU: 1000 * (i % 4)}, update_time=10.0))
    return bus, sched


def _arrive(bus, rng, t, n=12):
    for j in range(n):
        pod = PORT.pod(f"t{t}p{j}", {CPU: int(rng.integers(200, 1200)),
                                     MEM: int(rng.integers(128, 1024))})
        bus.apply(PORT.Kind.POD, pod.uid, pod)


def _dumps_for(flight_dir, trigger):
    return [p for p in os.listdir(flight_dir)
            if p.startswith(f"flight-{trigger}-")]


def _interval(ev):
    return ev["t0"], ev["t0"] + (ev["dur"] or 0.0)


def _overlaps(a, b):
    a0, a1 = _interval(a)
    b0, b1 = _interval(b)
    return a0 < b1 and b0 < a1


class _SlowFlight:
    """Stretches a dispatched solve's publisher-side finalize so the
    coordinator's overlap window is deterministic on any box."""

    def __init__(self, inner, delay_s):
        self.inner = inner
        self.delay_s = delay_s

    @property
    def timings(self):
        return self.inner.timings

    def finalize(self):
        time.sleep(self.delay_s)
        return self.inner.finalize()


# -- the trace of the pipelined loop -------------------------------------------

def test_trace_export_pipelined_overlap_serial_sequential():
    bus, sched = _wired()
    rng = np.random.default_rng(3)
    orig_async = sched.model.schedule_async
    sched.model.schedule_async = (
        lambda snapshot: _SlowFlight(orig_async(snapshot), 0.05))
    pipeline = TickPipeline(sched, log=lambda *a: None)
    _arrive(bus, rng, 0)
    for t in range(3):
        pipeline.submit_round(now=20.0 + t)
        _arrive(bus, rng, t + 1)
        pipeline.prestage(now=20.0 + t)
    pipeline.drain("test")
    pipeline.stop()

    parsed = json.loads(json.dumps(TRACER.chrome_trace()))
    events = parsed["traceEvents"]
    assert any(e.get("ph") == "M" and e["name"] == "thread_name"
               for e in events)
    for e in events:
        if e.get("ph") == "X":
            assert e["dur"] >= 1 and "ts" in e and "round" in e["args"]
    spans = TRACER.events()
    by_name = lambda n: [e for e in spans if e["name"] == n]  # noqa: E731
    for rb in by_name("read_back"):
        assert any(ds["round"] == rb["round"] and ds["t0"] <= rb["t0"]
                   and _interval(rb)[1] <= _interval(ds)[1] + 1e-6
                   for ds in by_name("device_solve"))
    for low in by_name("lower"):
        assert any(bt["round"] == low["round"]
                   and bt["t0"] <= low["t0"] + 1e-6
                   and _interval(low)[1] <= _interval(bt)[1] + 1e-6
                   for bt in by_name("begin_tick"))
    assert any(_overlaps(ps, ds) and ps["track"] != ds["track"]
               for ps in by_name("prestage")
               for ds in by_name("device_solve")), \
        "pipelined run must show prestage overlapping the device solve"

    TRACER.clear()
    bus2, sched2 = _wired()
    rng2 = np.random.default_rng(3)
    for t in range(3):
        _arrive(bus2, rng2, t)
        sched2.schedule_pending(now=20.0 + t)
    serial = TRACER.events()
    assert not [e for e in serial if e["name"] == "prestage"]
    solves = {e["round"]: e for e in serial if e["name"] == "device_solve"}
    for e in serial:
        prev = solves.get(e["round"] - 1)
        if prev is not None:
            assert e["t0"] >= _interval(prev)[1] - 1e-6


def _pipelined_log(enabled=True, window=False, tmp_path=None):
    TRACER.clear()
    TRACER.set_enabled(enabled)
    bus, sched = _wired()
    rng = np.random.default_rng(11)
    log = []
    pipeline = TickPipeline(sched, log=lambda *a: None,
                            on_result=lambda out: log.append(sorted(out.items())))
    if window:
        DEVICE_OBS.configure(profile_dir=str(tmp_path),
                             profile_min_interval_s=0.0)
        assert DEVICE_OBS.request_profile(rounds=2, device="cpu")["armed"]
    _arrive(bus, rng, 0)
    for t in range(4):
        pipeline.submit_round(now=20.0 + t)
        _arrive(bus, rng, t + 1)
        pipeline.prestage(now=20.0 + t)
    pipeline.drain("test")
    pipeline.stop()
    TRACER.set_enabled(True)
    return log


def test_pipelined_tracing_and_profiling_on_off_tick_identical(tmp_path):
    on = _pipelined_log(True)
    off = _pipelined_log(False)
    profiled = _pipelined_log(True, window=True, tmp_path=tmp_path)
    assert on == off == profiled and len(on) == 4
    profile = DEVICE_OBS.status()["profile"]
    assert len(profile["windows"]) == 1
    events = json.loads(open(profile["windows"][0]).read())["traceEvents"]
    tids = {}
    for e in events:
        tids.setdefault(e.get("name"), set()).add(e.get("tid"))
    assert "ktpu:device_solve" in tids and "ktpu:prestage" in tids
    if profile["threads"] == "all":
        # the publisher thread's read-back is in the window too
        assert tids["ktpu:read_back"] - tids["ktpu:device_solve"]


# -- failed rounds and publishes close their marks -----------------------------------

def test_failed_epilogue_closes_round_mark():
    bus, sched = _wired()
    _arrive(bus, np.random.default_rng(7), 0)

    def boom(result, pending, at):
        raise FencingError("deposed")

    sched._preempt_unplaced = boom
    with pytest.raises(FencingError):
        sched.schedule_pending(now=20.0)
    assert not any(k.startswith("round:") for k in TRACER.open_marks())


def test_failed_round_and_publish_close_their_marks():
    rng = np.random.default_rng(5)
    bus, sched = _wired()
    _arrive(bus, rng, 0)

    def bad_publish(result):
        raise RuntimeError("fenced")

    pipeline = TickPipeline(sched, publish=bad_publish, log=lambda *a: None)
    pipeline.submit_round(now=100.0)
    with pytest.raises(RuntimeError):
        pipeline.drain("test")
    pipeline.stop()
    assert not any(k.startswith("publish:") for k in TRACER.open_marks())

    bus2, sched2 = _wired()
    _arrive(bus2, rng, 1)

    def bad_dispatch(snapshot):
        raise RuntimeError("solver gone")

    sched2.model.schedule_async = bad_dispatch
    with pytest.raises(RuntimeError):
        sched2.begin_tick(now=100.0)
    assert not any(k.startswith("round:") for k in TRACER.open_marks())


# -- the flight recorder's triggers -----------------------------------------------------

def test_flight_trigger_fencing_abort(flight_dir):
    sched = PORT.scheduler()

    def boom(now=None):
        raise FencingError("deposed")

    sched.schedule_pending = boom
    before = components.FLIGHT_DUMPS.value({"trigger": "fencing-abort"})
    rc = cmd.run_loop(sched, cmd.SchedulerConfig(schedule_interval_seconds=0.01),
                      once=True, log=lambda *a: None)
    assert rc == 1
    assert len(_dumps_for(flight_dir, "fencing-abort")) == 1
    assert components.FLIGHT_DUMPS.value(
        {"trigger": "fencing-abort"}) == before + 1


def test_flight_trigger_deferred_pipeline_error(flight_dir):
    bus, sched = _wired(n_nodes=2)

    def bad_publish(out):
        raise RuntimeError("publish wedge")

    before = components.PIPELINE_DEFERRED_ERRORS.value({"kind": "other"})
    pipeline = TickPipeline(sched, publish=bad_publish, log=lambda *a: None)
    _arrive(bus, np.random.default_rng(7), 0, n=2)
    pipeline.submit_round(now=20.0)
    with pytest.raises(RuntimeError, match="publish wedge"):
        pipeline.drain("test")
    pipeline.stop()
    paths = _dumps_for(flight_dir, "pipeline-deferred-error")
    assert len(paths) == 1
    payload = json.loads((flight_dir / paths[0]).read_text())
    assert "RuntimeError" in payload["detail"]
    failed = [r for r in payload["rounds"] if r.get("error")]
    assert failed and "RuntimeError" in failed[-1]["error"]
    assert components.PIPELINE_DEFERRED_ERRORS.value(
        {"kind": "other"}) == before + 1


def test_flight_trigger_manual_holds_rounds_and_device(flight_dir):
    bus, sched = _wired(n_nodes=4)
    pipeline = TickPipeline(sched, log=lambda *a: None)
    rng = np.random.default_rng(2)
    for t in range(3):
        _arrive(bus, rng, t, n=3)
        pipeline.submit_round(now=30.0 + t)
        pipeline.prestage(now=30.0 + t)
    pipeline.drain("test")
    pipeline.stop()
    path = FLIGHT.trigger("manual", detail="operator")
    payload = json.loads(open(path).read())
    assert [r["round"] for r in payload["rounds"]][-3:] == [
        r["round"] for r in FLIGHT.recent_rounds()][-3:]
    assert all(r["placed"] == 3 and r["solver"] for r in payload["rounds"])
    assert payload["device"]["live"]["owners"]["staged_cache"] > 0
    assert "trace_tail" in payload
    # the warm pool's counters: inert here, so nothing served warm
    assert payload["warm"]["served"] == 0
    assert payload["warm"]["executables"] == 0


def test_flight_rate_limit(flight_dir):
    FLIGHT.configure(min_interval_s=60.0)
    assert FLIGHT.trigger("manual", detail="first") is not None
    assert FLIGHT.trigger("manual", detail="suppressed") is None
    assert len(_dumps_for(flight_dir, "manual")) == 1


def test_flight_dump_files_capped_on_disk(flight_dir):
    rec = flight_mod.FlightRecorder(dump_dir=str(flight_dir),
                                    min_interval_s=0.0, max_files=3)
    for i in range(8):
        rec.record_round({"round": i})
        assert rec.trigger("manual", detail=f"flap {i}") is not None
    files = sorted(p.name for p in flight_dir.glob("flight-manual-*.json"))
    assert files == ["flight-manual-0006.json", "flight-manual-0007.json",
                     "flight-manual-0008.json"]


# -- the stuck-cycle monitor --------------------------------------------------------------

def test_monitor_stuck_counts_once_and_clears():
    tracer = trace_mod.SpanTracer()
    mon = monitor_mod.SchedulerMonitor(tracer=tracer, timeout_seconds=5.0,
                                       log=lambda *a: None)
    stuck = components.STUCK_CYCLES
    before_round = stuck.value({"kind": "round"})
    before_pub = stuck.value({"kind": "publish"})
    tracer.mark_open("round:7")
    tracer.mark_open("publish:6")
    later = tracer.now() + 30.0
    assert sorted(mon.check_stuck(now=later)) == ["publish:6", "round:7"]
    mon.check_stuck(now=later + 1.0)
    assert stuck.value({"kind": "round"}) == before_round + 1
    assert stuck.value({"kind": "publish"}) == before_pub + 1
    tracer.mark_closed("round:7")
    tracer.mark_closed("publish:6")
    assert mon.check_stuck(now=later) == []
    tracer.mark_open("round:8")
    mon.check_stuck(now=later + 60.0)
    assert stuck.value({"kind": "round"}) == before_round + 2


def test_monitor_stuck_counts_once_across_monitors():
    tracer = trace_mod.SpanTracer()
    leader, standby = (monitor_mod.SchedulerMonitor(
        tracer=tracer, timeout_seconds=5.0, log=lambda *a: None)
        for _ in range(2))
    stuck = components.STUCK_CYCLES
    before = stuck.value({"kind": "round"})
    tracer.mark_open("round:9")
    later = tracer.now() + 30.0
    assert leader.check_stuck(now=later) == ["round:9"]
    assert standby.check_stuck(now=later) == ["round:9"]
    assert "round:9" in standby.status()["open_marks"]
    assert stuck.value({"kind": "round"}) == before + 1
    tracer.mark_closed("round:9")
    tracer.mark_open("round:9")
    leader.check_stuck(now=tracer.now() + 30.0)
    assert stuck.value({"kind": "round"}) == before + 2


def test_scheduler_registers_monitor_and_services():
    sched = PORT.scheduler()
    assert sched.monitor.tracer is TRACER
    assert sched.services.names() == ["Coscheduling", "ElasticQuota",
                                      "monitor", "pod-timelines"]
    assert sched.services.query("monitor")["stuck"] == []
    sched.debug.record_explain({"pod": "p"})
    assert list(sched.debug.explains) == [{"pod": "p"}]


# -- the device observatory on the CPU -------------------------------------------------

def _rounds(n, sched=None, bus=None, t0=40.0):
    if sched is None:
        bus, sched = _wired(n_nodes=4)
    rng = np.random.default_rng(9)
    out = []
    for t in range(n):
        _arrive(bus, rng, t, n=3)
        out.append(sorted(sched.schedule_pending(now=t0 + t).items()))
    return out, sched, bus


def test_profile_window_over_k_rounds_writes_one_trace(tmp_path):
    DEVICE_OBS.configure(profile_dir=str(tmp_path), profile_min_interval_s=0.0)
    before = components.DEVICE_PROFILE_WINDOWS.value({"result": "written"})
    armed = DEVICE_OBS.request_profile(rounds=2, device="cpu")
    assert armed == {"armed": True, "rounds": 2, "dir": str(tmp_path),
                     "device": "cpu"}
    _rounds(2)
    status = DEVICE_OBS.status()["profile"]
    assert status["active_rounds_left"] == 1 and status["windows"] == []
    assert not os.listdir(tmp_path)
    _rounds(1)                                # the third round closes it
    status = DEVICE_OBS.status()["profile"]
    assert status["active_rounds_left"] == 0 and status["last_error"] is None
    assert len(status["windows"]) == 1
    assert os.listdir(tmp_path) == ["window-0001.json"]
    assert components.DEVICE_PROFILE_WINDOWS.value(
        {"result": "written"}) == before + 1
    events = json.loads((tmp_path / "window-0001.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert {"ktpu:device_solve", "ktpu:read_back"} <= names
    assert not torch.autograd.profiler._is_profiler_enabled


def test_annotate_is_a_noop_outside_a_window(tmp_path):
    assert DEVICE_OBS.annotate("device_solve") is device_mod._NULL_CTX
    DEVICE_OBS.configure(profile_dir=str(tmp_path), profile_min_interval_s=0.0)
    DEVICE_OBS.request_profile(rounds=1, device="cpu")
    assert DEVICE_OBS.annotate("device_solve") is not device_mod._NULL_CTX
    _rounds(2)
    assert DEVICE_OBS.annotate("device_solve") is device_mod._NULL_CTX


def test_profile_rate_limit_refusal_and_disk_cap(tmp_path):
    DEVICE_OBS.configure(profile_dir=str(tmp_path), profile_min_interval_s=60.0,
                         profile_max_windows=1)
    assert DEVICE_OBS.request_profile(rounds=1, device="cpu")["armed"]
    assert DEVICE_OBS.request_profile(rounds=1, device="cpu")["error"] \
        == "profile window already armed/active"
    _out, sched, bus = _rounds(2)
    limited = DEVICE_OBS.request_profile(rounds=1, device="cpu")
    assert limited["error"] == "rate-limited" and limited["retry_in_s"] > 0
    DEVICE_OBS.configure(profile_min_interval_s=0.0)
    assert DEVICE_OBS.request_profile(rounds=1, device="cpu")["armed"]
    _rounds(2, sched, bus, t0=60.0)
    windows = DEVICE_OBS.status()["profile"]["windows"]
    assert len(windows) == 1 and windows[0].endswith("window-0002.json")
    assert os.listdir(tmp_path) == ["window-0002.json"]


def test_reset_stops_an_open_window(tmp_path):
    DEVICE_OBS.configure(profile_dir=str(tmp_path), profile_min_interval_s=0.0)
    DEVICE_OBS.request_profile(rounds=4, device="cpu")
    _rounds(1)
    assert torch.autograd.profiler._is_profiler_enabled
    DEVICE_OBS.reset()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert DEVICE_OBS.status()["profile"]["active_rounds_left"] == 0
    DEVICE_OBS.configure(profile_dir=str(tmp_path), profile_min_interval_s=0.0)
    DEVICE_OBS.request_profile(rounds=1, device="cpu")
    _rounds(2)
    assert len(DEVICE_OBS.status()["profile"]["windows"]) == 1


def test_profile_window_changes_no_placement(tmp_path):
    plain, _, _ = _rounds(3)
    DEVICE_OBS.configure(profile_dir=str(tmp_path), profile_min_interval_s=0.0)
    DEVICE_OBS.request_profile(rounds=2, device="cpu")
    profiled, _, _ = _rounds(3)
    assert plain == profiled


def test_staged_cache_is_a_live_bytes_owner():
    _out, sched, _bus = _rounds(1)
    live = DEVICE_OBS.live_snapshot()
    assert live["owners"]["staged_cache"] == \
        sched.model.staged_cache.device_bytes() > 0
    assert "bytes" not in live                   # no CUDA in this process
    flight = DEVICE_OBS.flight_payload()
    assert flight["live"]["owners"]["staged_cache"] > 0
    del sched, _bus, _out
    import gc

    gc.collect()
    assert DEVICE_OBS.live_snapshot()["owners"]["staged_cache"] == 0


def test_build_is_recorded_and_a_load_is_not(tmp_path, monkeypatch):
    before = components.DEVICE_COMPILES.value({"fn": "binpack_library"})
    DEVICE_OBS.record_compile(
        "binpack_library", 1.5,
        "nvcc note\nptxas info    : Used 64 registers\nother\n")
    ring = DEVICE_OBS.debug_payload()["recent_compiles"]
    assert ring[-1]["fn"] == "binpack_library" and ring[-1]["compile_s"] == 1.5
    assert ring[-1]["ptxas"] == ["ptxas info    : Used 64 registers"]
    assert components.DEVICE_COMPILES.value(
        {"fn": "binpack_library"}) == before + 1
    assert [e["name"] for e in TRACER.events()] == ["device-compile"]
    monkeypatch.setattr(bk, "BUILD_DIR", tmp_path)
    (tmp_path / f"libbinpack-{bk._digest()}.so").write_bytes(b"")
    bk.build_library()                         # already built: a load
    assert DEVICE_OBS.status()["compiles_total"] == 1
    DEVICE_OBS.set_enabled(False)
    DEVICE_OBS.record_compile("binpack_library", 1.0)
    DEVICE_OBS.set_enabled(True)
    assert DEVICE_OBS.status()["compiles_total"] == 1


def test_cuda_window_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEVICE_OBS.request_profile(rounds=1)
