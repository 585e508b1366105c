"""Debug/observability HTTP server: the mux every binary runs
(counterpart of ``koordinator_tpu/utils/debug_http.py``).

Reference: cmd/koord-scheduler/app/server.go:293-303 installs pprof, the
runtime-settable score/filter debug toggles (PUT /debug/flags/s and /f),
the per-plugin REST services (GET /apis/v1/plugins/<name>), plus
/metrics and /healthz on every binary.

One stdlib ThreadingHTTPServer serves the same surface over the port's
registries (``scheduler/monitor.DebugServices``, the metric registries
through ``metrics/registry.MergedGatherer``, ``obs/trace.TRACER``,
``obs/device.DEVICE_OBS``):

- ``GET /healthz``                  -> 200 "ok"
- ``GET /metrics``                  -> prometheus text exposition
- ``GET /apis/v1/plugins``          -> registered debug service names
- ``GET /apis/v1/plugins/<name>``   -> that service's JSON payload
- ``PUT /debug/flags/s|f?value=1``  -> toggle score/filter dumps
- ``GET /debug/dumps``              -> collected score/filter/explain dumps
- ``GET /debug/trace``              -> Chrome-trace-event JSON of the span
                                       tracer's ring (load in Perfetto)
- ``GET /debug/device``             -> the device observatory
                                       (``DEVICE_OBS.debug_payload``):
                                       kernel-library builds, the
                                       allocator's live bytes, the
                                       working set's pressure view
- ``GET /debug/profile?rounds=K``   -> arm a ``torch.profiler`` window
                                       over the next K scheduling rounds
                                       (429 when rate-limited or a
                                       window is already in play; 501
                                       when the profile callable reports
                                       ``unsupported``)
- ``GET /explain?pod=<uid>[&node=<name>]``
                                    -> placement explanation for one pod
- ``GET /audit?group=&subject=&operation=&since=&limit=``
                                    -> koordlet audit query
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse


class DebugHTTPServer:
    """Serves a DebugServices registry, a DebugRecorder, and a metrics
    gatherer (anything with ``gather() -> str``) on one port."""

    def __init__(self, services=None, debug=None, metrics=None,
                 auditor=None, tracer=None, explain=None,
                 device=None, profile=None,
                 host: str = "127.0.0.1", port: int = 0):
        self.services = services
        self.debug = debug
        self.metrics = metrics
        self.auditor = auditor
        #: a SpanTracer (obs/trace.py) served at /debug/trace
        self.tracer = tracer
        #: ``explain(pod_uid, node=None) -> dict`` served at /explain
        self.explain = explain
        #: ``device() -> dict`` served at /debug/device
        #: (DEVICE_OBS.debug_payload)
        self.device = device
        #: ``profile(rounds) -> dict`` served at /debug/profile
        #: (DEVICE_OBS.request_profile on the served device)
        self.profile = profile
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet by default
                pass

            def _send(self, code: int, body: str,
                      content_type: str = "application/json"):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                # service callables read live scheduler state from
                # handler threads: any race/iteration error must come
                # back as a 500, not an aborted connection
                try:
                    self._get()
                except Exception as e:
                    try:
                        self._send(500, json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}))
                    except Exception:
                        pass

            def _get(self):
                path = urlparse(self.path).path.rstrip("/")
                if path == "/healthz":
                    return self._send(200, "ok", "text/plain")
                if path == "/metrics":
                    if outer.metrics is None:
                        return self._send(404, "no metrics registry",
                                          "text/plain")
                    return self._send(200, outer.metrics.gather(),
                                      "text/plain; version=0.0.4")
                if path == "/apis/v1/plugins":
                    names = outer.services.names() if outer.services else []
                    return self._send(200, json.dumps(names))
                if path.startswith("/apis/v1/plugins/"):
                    name = path[len("/apis/v1/plugins/"):]
                    payload = (outer.services.query(name)
                               if outer.services else None)
                    if payload is None:
                        return self._send(404, json.dumps(
                            {"error": f"unknown plugin {name!r}"}))
                    return self._send(200, json.dumps(payload, default=str))
                if path == "/audit":
                    if outer.auditor is None:
                        return self._send(404, "no auditor", "text/plain")
                    q = parse_qs(urlparse(self.path).query)

                    def one(key):
                        return q.get(key, [None])[0]

                    events = outer.auditor.query(
                        group=one("group"), subject=one("subject"),
                        operation=one("operation"),
                        since=float(one("since")) if one("since") else None,
                        limit=int(one("limit")) if one("limit") else None,
                    )
                    import dataclasses as _dc

                    return self._send(200, json.dumps(
                        [_dc.asdict(e) for e in events]))
                if path == "/debug/dumps":
                    if outer.debug is None:
                        return self._send(404, "no debug recorder",
                                          "text/plain")
                    return self._send(200, json.dumps({
                        "scores": outer.debug.scores,
                        "filters": outer.debug.filters,
                        "explains": list(
                            getattr(outer.debug, "explains", ())
                        ),
                    }, default=str))
                if path == "/debug/trace":
                    if outer.tracer is None:
                        return self._send(404, "no tracer", "text/plain")
                    return self._send(
                        200, json.dumps(outer.tracer.chrome_trace(),
                                        default=str)
                    )
                if path == "/debug/device":
                    if outer.device is None:
                        return self._send(404, "no device observatory",
                                          "text/plain")
                    return self._send(
                        200, json.dumps(outer.device(), default=str)
                    )
                if path == "/debug/profile":
                    if outer.profile is None:
                        return self._send(404, "no device observatory",
                                          "text/plain")
                    q = parse_qs(urlparse(self.path).query)
                    try:
                        rounds = int(q.get("rounds", ["8"])[0])
                    except ValueError:
                        return self._send(400, json.dumps(
                            {"error": "rounds must be an integer"}))
                    payload = outer.profile(rounds)
                    # a permanent incapacity (no CUDA profiling in this
                    # build) is 501: a retry loop honoring 429 must not
                    # spin on it
                    if payload.get("unsupported"):
                        code = 501
                    elif "error" in payload:
                        code = 429
                    else:
                        code = 200
                    return self._send(code, json.dumps(payload,
                                                       default=str))
                if path == "/explain":
                    if outer.explain is None:
                        return self._send(404, "no explainer",
                                          "text/plain")
                    q = parse_qs(urlparse(self.path).query)
                    uid = q.get("pod", [None])[0]
                    if uid is None:
                        return self._send(400, json.dumps(
                            {"error": "missing ?pod=<uid>"}))
                    payload = outer.explain(
                        uid, node=q.get("node", [None])[0]
                    )
                    return self._send(200, json.dumps(payload, default=str))
                return self._send(404, "not found", "text/plain")

            def do_PUT(self):
                try:
                    self._put()
                except Exception as e:
                    try:
                        self._send(500, json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}))
                    except Exception:
                        pass

            def _put(self):
                # the reference's runtime toggles: PUT /debug/flags/s, /f
                # with value=1|0 (server.go:300-303 DebugScoresSetter)
                parsed = urlparse(self.path)
                path = parsed.path.rstrip("/")
                if outer.debug is not None and path in (
                    "/debug/flags/s", "/debug/flags/f"
                ):
                    raw = parse_qs(parsed.query).get("value", ["1"])[0]
                    on = raw.lower() not in ("0", "false", "off")
                    if path.endswith("/s"):
                        outer.debug.dump_scores = on
                    else:
                        outer.debug.dump_filters = on
                    return self._send(200, json.dumps({"enabled": on}))
                return self._send(404, "not found", "text/plain")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "DebugHTTPServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
