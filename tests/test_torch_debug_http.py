"""The port's debug mux (``utils/debug_http.py``), route for route as
``tests/test_debug_http.py`` covers the reference's: ``/healthz`` and
``/metrics``, the plugin services, the score/filter dump toggles, the
audit query, a handler error as 500, and the routes the solver serves:
``/debug/trace``, ``/debug/device``, ``/debug/profile`` (200, 429 and
501) and ``/explain``; then the solver's own mux
(``cmd/solver.start_debug_server``) over a CPU ``PlacementService``."""

import dataclasses
import json
import urllib.error
import urllib.request

import pytest

from koordinator_tpu_torch.apis.extension import ResourceName as R
from koordinator_tpu_torch.apis.types import NodeMetric, NodeSpec
from koordinator_tpu_torch.cmd import solver
from koordinator_tpu_torch.metrics.registry import Registry
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.obs.trace import SpanTracer
from koordinator_tpu_torch.scheduler.scheduler import Scheduler
from koordinator_tpu_torch.service.server import PlacementService
from koordinator_tpu_torch.state.workingset import WORKING_SET
from koordinator_tpu_torch.utils.debug_http import DebugHTTPServer


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read().decode()


def _put(port, path):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 method="PUT")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.status, r.read().decode()


def _code(port, path):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, path)
    return e.value.code, json.loads(e.value.read().decode() or "{}")


def _put_code(port, path):
    with pytest.raises(urllib.error.HTTPError) as e:
        _put(port, path)
    return e.value.code, None


@pytest.fixture
def served_scheduler():
    s = Scheduler(model=PlacementModel(device="cpu"))
    s.add_node(NodeSpec(name="n0", allocatable={R.CPU: 8000,
                                                R.MEMORY: 16384}))
    s.update_node_metric(NodeMetric(node_name="n0", update_time=99.0))
    registry = Registry("test")
    registry.counter("rounds_total", "rounds").inc()
    server = DebugHTTPServer(services=s.services, debug=s.debug,
                             metrics=registry).start()
    yield s, server
    server.stop()


def test_healthz_and_metrics(served_scheduler):
    _, server = served_scheduler
    assert _get(server.port, "/healthz") == (200, "ok")
    status, body = _get(server.port, "/metrics")
    assert status == 200 and "rounds_total" in body


def test_plugin_services(served_scheduler):
    s, server = served_scheduler
    s.services.register("probe", lambda: {"ok": 1})
    status, body = _get(server.port, "/apis/v1/plugins")
    assert status == 200 and "probe" in json.loads(body)
    assert _get(server.port, "/apis/v1/plugins/probe") == (200, '{"ok": 1}')
    code, body = _code(server.port, "/apis/v1/plugins/nope")
    assert code == 404 and "nope" in body["error"]


def test_debug_flag_toggles_collect_dumps(served_scheduler):
    s, server = served_scheduler
    _, body = _get(server.port, "/debug/dumps")
    assert json.loads(body) == {"scores": [], "filters": [], "explains": []}
    assert _put(server.port, "/debug/flags/s")[0] == 200
    assert _put(server.port, "/debug/flags/f?value=1")[0] == 200
    assert s.debug.dump_scores and s.debug.dump_filters
    s.debug.record_scores("default/p0", {"n0": 42})
    _, body = _get(server.port, "/debug/dumps")
    assert json.loads(body)["scores"]
    status, body = _put(server.port, "/debug/flags/s?value=0")
    assert json.loads(body) == {"enabled": False}
    assert s.debug.dump_scores is False
    code, _ = _put_code(server.port, "/debug/flags/x")
    assert code == 404


def test_audit_query_endpoint():
    @dataclasses.dataclass
    class Event:
        group: str
        detail: str

    seen = {}

    class Auditor:
        def query(self, **kw):
            seen.update(kw)
            return [Event("qosmanager/cpusuppress", "cpus=4")]

    server = DebugHTTPServer(auditor=Auditor()).start()
    try:
        _, body = _get(server.port,
                       "/audit?group=qosmanager/cpusuppress&limit=5&since=1")
        assert json.loads(body) == [{"group": "qosmanager/cpusuppress",
                                     "detail": "cpus=4"}]
        assert seen == {"group": "qosmanager/cpusuppress", "subject": None,
                        "operation": None, "since": 1.0, "limit": 5}
    finally:
        server.stop()


def test_handler_error_returns_500():
    class Boom:
        def names(self):
            raise RuntimeError("dictionary changed size during iteration")

    server = DebugHTTPServer(services=Boom()).start()
    try:
        code, body = _code(server.port, "/apis/v1/plugins")
        assert code == 500 and "RuntimeError" in body["error"]
    finally:
        server.stop()


def test_trace_device_profile_and_explain_routes():
    tracer = SpanTracer()
    tracer.emit("sidecar_solve", cat="sidecar", t0=tracer.now())
    answers = iter([{"armed": True, "rounds": 2}, {"error": "rate-limited"},
                    {"unsupported": True, "error": "no CUDA profiling"}])
    server = DebugHTTPServer(
        tracer=tracer, device=lambda: {"live": {"owners": {}}},
        profile=lambda rounds: dict(next(answers), asked=rounds),
        explain=lambda uid, node=None: {"pod": uid, "node": node}).start()
    try:
        _, body = _get(server.port, "/debug/trace")
        names = [e["name"] for e in json.loads(body)["traceEvents"]]
        assert "sidecar_solve" in names
        assert json.loads(_get(server.port, "/debug/device")[1]) == \
            {"live": {"owners": {}}}
        status, body = _get(server.port, "/debug/profile?rounds=2")
        assert status == 200 and json.loads(body)["asked"] == 2
        assert _code(server.port, "/debug/profile")[0] == 429
        assert _code(server.port, "/debug/profile?rounds=3")[0] == 501
        assert _code(server.port, "/debug/profile?rounds=x")[0] == 400
        _, body = _get(server.port, "/explain?pod=default/p0&node=n1")
        assert json.loads(body) == {"pod": "default/p0", "node": "n1"}
        assert _code(server.port, "/explain")[0] == 400
    finally:
        server.stop()
    bare = DebugHTTPServer().start()
    try:
        for path in ("/metrics", "/debug/trace", "/debug/device",
                     "/debug/profile", "/explain?pod=x", "/audit",
                     "/debug/dumps", "/nope"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(bare.port, path)
            assert e.value.code == 404, path
        assert json.loads(_get(bare.port, "/apis/v1/plugins")[1]) == []
    finally:
        bare.stop()


def test_solver_mux_serves_the_sidecar(tmp_path):
    WORKING_SET.reset()
    service = PlacementService(str(tmp_path / "s.sock"), device="cpu")
    service.start()
    mux = solver.start_debug_server(service, 0)
    try:
        assert _get(mux.port, "/healthz") == (200, "ok")
        _, body = _get(mux.port, "/metrics")
        for series in ("solver_admission_requests_total",
                       "solver_device_compile_total",
                       "scheduler_hbm_budget_bytes"):
            assert series in body, series
        names = json.loads(_get(mux.port, "/apis/v1/plugins")[1])
        assert sorted(names) == ["device-observatory", "solver", "trace",
                                 "workingset"]
        status = json.loads(_get(mux.port, "/apis/v1/plugins/solver")[1])
        assert status["solve_device"] == "cpu"
        assert "workingset" in status["device"]["live"]
        ws = json.loads(_get(mux.port, "/apis/v1/plugins/workingset")[1])
        assert ws["residents"] == {"device": 0, "host": 0, "cold": 0}
        device = json.loads(_get(mux.port, "/debug/device")[1])
        assert "compiles_total" in device
    finally:
        mux.stop()
        service.stop()
