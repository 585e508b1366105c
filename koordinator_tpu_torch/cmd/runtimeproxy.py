"""koord-runtime-proxy entry point: the CRI interposer daemon
(counterpart of ``koordinator_tpu/cmd/runtimeproxy.py``).

    python -m koordinator_tpu_torch.cmd.runtimeproxy --listen "$TMPDIR/p.sock" --once

Reference: cmd/koord-runtime-proxy/main.go — flags for the proxy
endpoint, the real runtime endpoint, and the failure policy; the server
interposes kubelet↔containerd CRI calls and dispatches the hook server
pre/post (pkg/runtimeproxy/server/cri/criserver.go:44,90-102).

The in-process transport serves the interposer over a framed-JSON UDS
socket: each line is a CRIRequest
``{"method", "pod_uid", "container"?, "payload"?}`` — ``container``
names the container for container-level methods; the reply carries the
hook-merged resources. A kubelet stand-in (tests,
demos) connects instead of gRPC — the interception/merge/failover logic
is the same `RuntimeManagerCriServer` the library exposes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socketserver
import tempfile
from typing import Optional

from koordinator_tpu_torch.runtimeproxy.criserver import (
    BackendRuntime,
    CRIRequest,
    RuntimeManagerCriServer,
)


def default_listen() -> str:
    """The default endpoint: ``koord-runtimeproxy.sock`` in the temporary
    directory (``$TMPDIR``), as ``cmd/solver``'s."""
    return os.path.join(tempfile.gettempdir(), "koord-runtimeproxy.sock")


@dataclasses.dataclass
class RuntimeProxyConfig:
    """Component config (main.go flag surface)."""

    listen: str = dataclasses.field(default_factory=default_listen)
    failure_policy: str = "ignore"  # ignore | fail


class NullBackend:
    """Stands in for the real container runtime when none is attached
    (the reference requires containerd; demos run hook dispatch only)."""

    def handle(self, request: CRIRequest) -> object:
        return {"ok": True, "method": request.method}

    def list_pods(self):
        return []


def build_proxy(config: RuntimeProxyConfig, hook_server=None,
                backend: Optional[BackendRuntime] = None):
    from koordinator_tpu_torch.koordlet.runtimehooks import (
        FailurePolicy,
        HookRegistry,
        RuntimeHookServer,
    )

    if hook_server is None:
        hook_server = RuntimeHookServer(HookRegistry(), executor=None)
    policy = (
        FailurePolicy.FAIL if config.failure_policy == "fail"
        else FailurePolicy.IGNORE
    )
    proxy = RuntimeManagerCriServer(
        hook_server, backend or NullBackend(), failure_policy=policy
    )
    proxy.fail_over()
    return proxy


def serve(proxy: RuntimeManagerCriServer, listen: str, once: bool = False,
          log=print) -> int:
    """Line-framed JSON request loop over UDS."""
    import socket

    if os.path.exists(listen):
        # a dead predecessor leaves its socket behind; unlink it iff
        # nothing is accepting — never hijack a live proxy's endpoint
        # (same restart-in-place flow as service/server.py)
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            try:
                probe.connect(listen)
            except OSError:
                os.unlink(listen)
            else:
                raise OSError(f"address in use: {listen}")
        finally:
            probe.close()

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for line in self.rfile:
                try:
                    req = json.loads(line)
                    payload = dict(req.get("payload", {}))
                    # the documented frame carries pod_uid at top level;
                    # intercept() resolves it from the payload
                    if "pod_uid" in req:
                        payload.setdefault("pod_uid", req["pod_uid"])
                    request = CRIRequest(
                        method=req["method"],
                        container=req.get("container"),
                        payload=payload,
                    )
                    response = proxy.intercept(request)
                    out = {
                        "backend": response.backend_response,
                        "hook": (
                            dataclasses.asdict(response.hook_response)
                            if response.hook_response is not None else None
                        ),
                    }
                    # serialize INSIDE the guard: an un-JSONable backend
                    # response must yield an error frame, not a dead
                    # connection
                    frame = json.dumps(out)
                except Exception as e:  # a bad frame must not kill the proxy
                    frame = json.dumps({"error": f"{type(e).__name__}: {e}"})
                self.wfile.write((frame + "\n").encode())
                self.wfile.flush()

    if once:
        # single-connection smoke: serve it SYNCHRONOUSLY so the process
        # doesn't exit (killing daemon threads) while replies are in
        # flight
        with socketserver.UnixStreamServer(listen, Handler) as server:
            log(f"koord-runtime-proxy listening on {listen}")
            server.handle_request()
        return 0

    class Server(socketserver.ThreadingUnixStreamServer):
        daemon_threads = True

    with Server(listen, Handler) as server:
        log(f"koord-runtime-proxy listening on {listen}")
        server.serve_forever()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("koord-runtime-proxy")
    parser.add_argument("--listen", default=default_listen(),
                        help="UDS path for the interposed CRI endpoint")
    parser.add_argument("--failure-policy", choices=("ignore", "fail"),
                        default="ignore")
    parser.add_argument("--once", action="store_true",
                        help="serve a single connection and exit (smoke)")
    args = parser.parse_args(argv)
    config = RuntimeProxyConfig(listen=args.listen,
                                failure_policy=args.failure_policy)
    proxy = build_proxy(config)
    return serve(proxy, config.listen, once=args.once)


if __name__ == "__main__":
    raise SystemExit(main())
