"""The port's CRI proxy (``runtimeproxy/``, ``cmd/runtimeproxy.py``)
against the JAX package's. The cases are those of
``tests/test_runtimeproxy.py`` and
``tests/test_hooks_actuation.py::test_injection_through_cri_proxy``: each
runs both packages' proxies over the same recording backend with equal
hook registries, asserts the reference's expectations and returns what
it observed (the requests the backend saw, the responses, the store);
the two must be equal. Both binaries' ``main(["--once", ...])``, and
``serve`` over a proxy with hooks, answer one client's frames on a short
UDS path with reply frames equal as bytes."""

import dataclasses
import enum
import importlib
import json
import os
import shutil
import socket
import tempfile
import threading
import time

import pytest


class Pkg:
    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.X = mod("apis.extension")
        self.FW = mod("koordlet.metricsadvisor.framework")
        self.HK = mod("koordlet.runtimehooks.hooks")
        self.SV = mod("koordlet.runtimehooks.server")
        self.GI = mod("koordlet.runtimehooks.groupidentity")
        self.DV = mod("koordlet.runtimehooks.devices")
        self.SLO = mod("manager.sloconfig")
        self.RP = mod("runtimeproxy")
        self.CMD = mod("cmd.runtimeproxy")


REF = Pkg("koordinator_tpu")
PORT = Pkg("koordinator_tpu_torch")


def plain(x):
    if isinstance(x, enum.Enum):
        return x.name
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


class RecordingBackend:
    """A container runtime stand-in: records what it was forwarded."""

    def __init__(self, pods=(), order=None):
        self.requests = []
        self._pods = list(pods)
        self._order = order

    def handle(self, request):
        if self._order is not None:
            self._order.append("backend")
        self.requests.append(request)
        return {"ok": True, "method": request.method}

    def list_pods(self):
        return self._pods


def be_pod(P, uid="be1"):
    return P.FW.PodMeta(
        uid=uid, cgroup_dir=f"kubepods/besteffort/pod{uid}",
        qos=P.X.QoSClass.BE,
        containers={"c0": f"kubepods/besteffort/pod{uid}/c0"},
    )


def gpu_pod(P, uid="p3", minors=(1,)):
    annotations = {P.X.ANNOTATION_DEVICE_ALLOCATED: json.dumps({
        "gpu": [{"minor": m, "resources": {}} for m in minors],
        "rdma": [{"minor": 0, "resources": {}, "vfs": ["0000:81:00.2"]}],
    })}
    return P.FW.PodMeta(uid, f"kubepods/pod{uid}", P.X.QoSClass.LSR,
                        containers={"main": f"kubepods/pod{uid}/main"},
                        annotations=annotations)


def boom(ctx):
    raise RuntimeError("hook down")


def observed(proxy, backend, outs):
    return {
        "requests": plain(backend.requests),
        "responses": [plain(dataclasses.replace(o, request=None))
                      for o in outs],
        "store": sorted(proxy.store.pods),
    }


def case_hooked(P):
    registry = P.HK.HookRegistry()
    seen = []

    def set_shares(ctx):
        seen.append(ctx.request.pod_meta.uid)
        ctx.response.cpu_shares = 2

    registry.register(P.HK.Stage.PRE_CREATE_CONTAINER, "set-shares", "",
                      set_shares)
    backend = RecordingBackend()
    proxy = P.RP.RuntimeManagerCriServer(P.SV.RuntimeHookServer(registry),
                                         backend)
    out = proxy.intercept(P.RP.CRIRequest(method="CreateContainer",
                                          pod=be_pod(P), container="c0"))
    assert seen == ["be1"]
    assert backend.requests[0].resources.cpu_shares == 2
    assert out.backend_response["ok"]
    return observed(proxy, backend, [out])


def case_transparent(P):
    backend = RecordingBackend()
    proxy = P.RP.RuntimeManagerCriServer(
        P.SV.RuntimeHookServer(P.HK.HookRegistry()), backend)
    req = P.RP.CRIRequest(method="ListImages")
    out = proxy.intercept(req)
    assert backend.requests == [req]
    assert out.hook_response is None
    return observed(proxy, backend, [out])


def case_store(P):
    backend = RecordingBackend()
    proxy = P.RP.RuntimeManagerCriServer(
        P.SV.RuntimeHookServer(P.HK.HookRegistry()), backend)
    pod = be_pod(P)
    outs = [proxy.intercept(P.RP.CRIRequest(method="RunPodSandbox",
                                            pod=pod))]
    assert proxy.store.pod("be1") is pod
    req = P.RP.CRIRequest(method="UpdateContainerResources", container="c0",
                          payload={"pod_uid": "be1"})
    outs.append(proxy.intercept(req))
    assert backend.requests[-1] is req
    outs.append(proxy.intercept(P.RP.CRIRequest(method="StopPodSandbox",
                                                pod=pod)))
    assert proxy.store.pod("be1") is None
    return observed(proxy, backend, outs)


def case_ignore(P):
    registry = P.HK.HookRegistry()
    registry.register(P.HK.Stage.PRE_CREATE_CONTAINER, "boom", "", boom)
    backend = RecordingBackend()
    proxy = P.RP.RuntimeManagerCriServer(
        P.SV.RuntimeHookServer(registry), backend,
        failure_policy=P.HK.FailurePolicy.IGNORE)
    out = proxy.intercept(P.RP.CRIRequest(method="CreateContainer",
                                          pod=be_pod(P), container="c0"))
    assert out.backend_response["ok"]
    assert out.hook_response is None
    assert backend.requests[0].resources.cpu_shares is None
    return observed(proxy, backend, [out])


def case_fail(P):
    registry = P.HK.HookRegistry()
    registry.register(P.HK.Stage.PRE_CREATE_CONTAINER, "boom", "", boom)
    backend = RecordingBackend()
    # the proxy's Fail policy governs over the server's default Ignore
    proxy = P.RP.RuntimeManagerCriServer(
        P.SV.RuntimeHookServer(registry), backend,
        failure_policy=P.HK.FailurePolicy.FAIL)
    with pytest.raises(RuntimeError) as exc:
        proxy.intercept(P.RP.CRIRequest(method="CreateContainer",
                                        pod=be_pod(P), container="c0"))
    assert backend.requests == []
    return {"error": str(exc.value), **observed(proxy, backend, [])}


def case_post_stop(P):
    registry = P.HK.HookRegistry()
    order = []

    def post_stop(ctx):
        order.append("hook")
        raise RuntimeError("post-stop hook down")

    registry.register(P.HK.Stage.POST_STOP_POD_SANDBOX, "ps", "", post_stop)
    backend = RecordingBackend(order=order)
    proxy = P.RP.RuntimeManagerCriServer(
        P.SV.RuntimeHookServer(registry), backend,
        failure_policy=P.HK.FailurePolicy.FAIL)
    pod = be_pod(P)
    proxy.store.record_pod(pod)
    out = proxy.intercept(P.RP.CRIRequest(method="StopPodSandbox", pod=pod))
    assert order == ["backend", "hook"]
    assert out.backend_response["ok"]
    assert proxy.store.pod(pod.uid) is None
    return {"order": order, **observed(proxy, backend, [out])}


def case_post_start(P):
    registry = P.HK.HookRegistry()
    order = []
    registry.register(P.HK.Stage.PRE_START_CONTAINER, "pre", "",
                      lambda ctx: order.append("pre"))
    registry.register(P.HK.Stage.POST_START_CONTAINER, "post", "",
                      lambda ctx: order.append("post"))
    backend = RecordingBackend(order=order)
    proxy = P.RP.RuntimeManagerCriServer(P.SV.RuntimeHookServer(registry),
                                         backend)
    out = proxy.intercept(P.RP.CRIRequest(method="StartContainer",
                                          pod=be_pod(P), container="c0"))
    assert order == ["pre", "backend", "post"]
    return {"order": order, **observed(proxy, backend, [out])}


def case_fail_over(P):
    pods = [be_pod(P, "a"), be_pod(P, "b")]
    backend = RecordingBackend(pods=pods)
    proxy = P.RP.RuntimeManagerCriServer(
        P.SV.RuntimeHookServer(P.HK.HookRegistry()), backend)
    assert proxy.fail_over() == 2
    assert proxy.store.pod("a") is pods[0]
    assert proxy.store.pod("b") is pods[1]
    return {"pods": plain([proxy.store.pod(u) for u in ("a", "b")]),
            **observed(proxy, backend, [])}


def case_group_identity(P):
    registry = P.HK.HookRegistry()
    plugin = P.GI.BvtPlugin()
    plugin.register(registry)
    plugin.update_rule(P.SLO.NodeSLOSpec(
        resource_qos_strategy=P.SLO.ResourceQOSStrategy(
            be=P.SLO.QoSConfig(enable=True,
                               cpu=P.SLO.CPUQOS(group_identity=-1)))))
    backend = RecordingBackend()
    proxy = P.RP.RuntimeManagerCriServer(P.SV.RuntimeHookServer(registry),
                                         backend)
    out = proxy.intercept(P.RP.CRIRequest(method="RunPodSandbox",
                                          pod=be_pod(P)))
    assert out.hook_response.cpu_bvt == -1
    assert backend.requests[0].resources.cpu_bvt == -1
    return observed(proxy, backend, [out])


def case_device_injection(P):
    """The device hook's env merges into the container creation request
    the runtime sees: the allocator's output lands in the container."""
    registry = P.HK.HookRegistry()
    P.DV.DeviceEnvPlugin().register(registry)
    backend = RecordingBackend()
    proxy = P.RP.RuntimeManagerCriServer(P.SV.RuntimeHookServer(registry),
                                         backend)
    pod = gpu_pod(P)
    outs = [proxy.intercept(P.RP.CRIRequest(method="RunPodSandbox", pod=pod)),
            proxy.intercept(P.RP.CRIRequest(method="CreateContainer",
                                            pod=pod, container="main"))]
    envs = backend.requests[-1].resources.add_envs
    assert envs["TPU_VISIBLE_CHIPS"] == "1"
    assert envs["NVIDIA_VISIBLE_DEVICES"] == "1"
    return observed(proxy, backend, outs)


CASES = [case_hooked, case_transparent, case_store, case_ignore, case_fail,
         case_post_stop, case_post_start, case_fail_over,
         case_group_identity, case_device_injection]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_proxy_equals_reference(case):
    assert case(PORT) == case(REF)


def test_resources_fields_are_the_references():
    """``serve`` writes ``dataclasses.asdict`` of the hook response: the
    same names in the same order, or the frames differ."""
    names = [f.name for f in dataclasses.fields(PORT.RP.criserver.Resources)]
    assert names == [f.name for f in
                     dataclasses.fields(REF.RP.criserver.Resources)]


# -- the binary over a UDS ------------------------------------------------------

FRAMES = [
    {"method": "RunPodSandbox", "pod_uid": "p3"},
    {"method": "CreateContainer", "pod_uid": "p3", "container": "main"},
    {"method": "StartContainer", "pod_uid": "p3", "container": "main"},
    {"method": "ListImages", "payload": {"filter": "x"}},
    {"method": "StopContainer", "pod_uid": "p3", "container": "main"},
    {"method": "StopPodSandbox", "pod_uid": "p3"},
]


def exchange(path, frames, raw_tail=b"not json\n"):
    """One client: every frame as a JSON line (and a malformed line),
    each reply line as bytes."""
    deadline = time.monotonic() + 20
    while True:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.connect(path)
            break
        except OSError:
            sock.close()
            if time.monotonic() > deadline:
                raise
            time.sleep(0.01)
    replies = []
    with sock, sock.makefile("rb") as rf:
        for line in [json.dumps(f).encode() + b"\n" for f in frames] + [
                raw_tail]:
            sock.sendall(line)
            replies.append(rf.readline())
    return replies


def serve_once(P, run, frames):
    """``run(path)`` serving one connection on a UDS path in a fresh
    directory of ``$TMPDIR`` (shorter than a ``tmp_path``, whose test name
    can take a socket path past the 107-byte limit) while a client sends
    ``frames``; returns the reply lines and ``run``'s result."""
    d = tempfile.mkdtemp(prefix="rp")
    path = os.path.join(d, "p.sock")
    result = {}
    t = threading.Thread(target=lambda: result.update(rc=run(path)))
    t.start()
    try:
        replies = exchange(path, frames)
    finally:
        t.join(timeout=20)
        shutil.rmtree(d, ignore_errors=True)
    assert not t.is_alive()
    return replies, result.get("rc")


def test_main_once_frames_equal_reference(capsys):
    got = {}
    for P in (REF, PORT):
        got[P.root] = serve_once(
            P, lambda path: P.CMD.main(["--once", "--listen", path]), FRAMES)
    assert got["koordinator_tpu_torch"] == got["koordinator_tpu"]
    replies, rc = got["koordinator_tpu_torch"]
    assert rc == 0
    assert json.loads(replies[0]) == {
        "backend": {"ok": True, "method": "RunPodSandbox"}, "hook": None}
    assert "error" in json.loads(replies[-1])
    assert "listening on" in capsys.readouterr().out


def test_serve_hooked_proxy_frames_equal_reference():
    """``serve`` over a proxy whose store knows the pod and whose device
    hook answers: the reply's ``hook`` is the merged ``Resources``, byte
    for byte the reference's."""
    got = {}
    for P in (REF, PORT):
        registry = P.HK.HookRegistry()
        P.DV.DeviceEnvPlugin().register(registry)
        backend = RecordingBackend(pods=[gpu_pod(P)])
        proxy = P.CMD.build_proxy(P.CMD.RuntimeProxyConfig(),
                                  hook_server=P.SV.RuntimeHookServer(registry),
                                  backend=backend)
        replies, _ = serve_once(
            P, lambda path: P.CMD.serve(proxy, path, once=True,
                                        log=lambda *_a: None), FRAMES)
        got[P.root] = (replies, plain(backend.requests))
    assert got["koordinator_tpu_torch"] == got["koordinator_tpu"]
    hook = json.loads(got["koordinator_tpu_torch"][0][1])["hook"]
    assert hook["add_envs"]["NVIDIA_VISIBLE_DEVICES"] == "1"


def test_serve_refuses_a_live_endpoint():
    """A live proxy's endpoint is never hijacked; a dead predecessor's
    socket file is unlinked and served."""
    d = tempfile.mkdtemp(prefix="rp")
    path = os.path.join(d, "p.sock")
    try:
        live = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        live.bind(path)
        live.listen(1)
        proxy = PORT.CMD.build_proxy(PORT.CMD.RuntimeProxyConfig())
        with pytest.raises(OSError, match="address in use"):
            PORT.CMD.serve(proxy, path, once=True, log=lambda *_a: None)
        live.close()  # dead now: its file stays behind
        t = threading.Thread(target=PORT.CMD.serve, args=(proxy, path),
                             kwargs={"once": True, "log": lambda *_a: None})
        t.start()
        replies = exchange(path, FRAMES[:1])
        t.join(timeout=20)
        assert json.loads(replies[0])["backend"]["ok"] is True
    finally:
        shutil.rmtree(d, ignore_errors=True)
