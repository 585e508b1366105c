"""The CRI interposer server (counterpart of
``koordinator_tpu/runtimeproxy/criserver.py``): the path by which the
runtime hooks' cpuset and GPU env reach the container runtime.

Reference: pkg/runtimeproxy/server/cri/criserver.go —
``InterceptRuntimeRequest`` (:125-170): for hooked service types, run the
pre-hook, merge the hook's resource response into the request, forward to
the backend runtime, then run the post-hook; unknown methods flow through
the TransparentHandler untouched (:89-94). ``failOver`` (:79) rebuilds
the store from the backend's live pods/containers when the proxy
restarts. The hook failure policy (config.go:24-33) decides whether a
hook error fails the CRI call (Fail) or forwards unmodified (Ignore).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol

from koordinator_tpu_torch.koordlet.metricsadvisor.framework import PodMeta
from koordinator_tpu_torch.koordlet.runtimehooks.hooks import FailurePolicy
from koordinator_tpu_torch.koordlet.runtimehooks.protocol import Resources
from koordinator_tpu_torch.koordlet.runtimehooks.server import RuntimeHookServer


@dataclasses.dataclass
class CRIRequest:
    """One CRI call: typed method + the pod/container it concerns.

    ``resources`` carries the request's linux resource parameters; the
    interposer overlays the hook response onto it before forwarding (the
    reference mutates the protobuf request in place).
    """

    method: str                      # e.g. "RunPodSandbox"
    pod: Optional[PodMeta] = None
    container: Optional[str] = None  # container name
    resources: Resources = dataclasses.field(default_factory=Resources)
    payload: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CRIResponse:
    request: CRIRequest
    backend_response: object = None
    hook_response: Optional[Resources] = None


class BackendRuntime(Protocol):
    """The real runtime behind the proxy (containerd/dockerd stand-in)."""

    def handle(self, request: CRIRequest) -> object: ...

    def list_pods(self) -> List[PodMeta]: ...


class RuntimeProxyStore:
    """Pod/container metadata across calls (store/store.go): the hook
    stages after RunPodSandbox need the sandbox's annotations/cgroup
    parent, which later CRI calls don't repeat."""

    def __init__(self):
        self.pods: Dict[str, PodMeta] = {}

    def record_pod(self, pod: PodMeta) -> None:
        self.pods[pod.uid] = pod

    def pod(self, uid: str) -> Optional[PodMeta]:
        return self.pods.get(uid)

    def delete_pod(self, uid: str) -> None:
        self.pods.pop(uid, None)


#: method -> (pre-forward runner, post-forward runner) names on
#: RuntimeHookServer; stop/post hooks run AFTER the runtime acted
_HOOKED = {
    "RunPodSandbox": ("run_pod_sandbox", None),
    "StopPodSandbox": (None, "stop_pod_sandbox"),
    "CreateContainer": ("create_container", None),
    "StartContainer": ("start_container", "post_start_container"),
    "UpdateContainerResources": ("update_container_resources", None),
    "StopContainer": (None, "stop_container"),
}

_POD_METHODS = {"RunPodSandbox", "StopPodSandbox"}


class RuntimeManagerCriServer:
    """The interposer: hooked methods go pre-hook → backend → bookkeeping;
    everything else passes through transparently."""

    def __init__(
        self,
        hook_server: RuntimeHookServer,
        backend: BackendRuntime,
        failure_policy: FailurePolicy = FailurePolicy.IGNORE,
    ):
        self.hook_server = hook_server
        self.backend = backend
        self.failure_policy = failure_policy
        self.store = RuntimeProxyStore()

    # -- startup (criserver.go:79 failOver) ---------------------------------

    def fail_over(self) -> int:
        """Rebuild the store from the backend's live pods after a proxy
        restart; returns how many pods were recovered."""
        count = 0
        for pod in self.backend.list_pods():
            self.store.record_pod(pod)
            count += 1
        return count

    # -- interception --------------------------------------------------------

    def intercept(self, request: CRIRequest) -> CRIResponse:
        """The gRPC unary interceptor equivalent
        (InterceptRuntimeRequest :125)."""
        runners = _HOOKED.get(request.method)
        if runners is None:
            # TransparentHandler: forward untouched (:89-94)
            return CRIResponse(
                request=request, backend_response=self.backend.handle(request)
            )

        pod = request.pod
        if pod is None and request.payload.get("pod_uid"):
            pod = self.store.pod(request.payload["pod_uid"])
        if pod is None:
            return CRIResponse(
                request=request, backend_response=self.backend.handle(request)
            )

        pre_name, post_name = runners
        hook_response: Optional[Resources] = None

        def run_hook(name: str) -> Optional[Resources]:
            # the PROXY's failure policy governs, regardless of the hook
            # server's own default (hooks must surface errors to us)
            try:
                runner = getattr(self.hook_server, name)
                if request.method in _POD_METHODS:
                    return runner(pod, apply=False, policy=FailurePolicy.FAIL)
                return runner(
                    pod, request.container or "", apply=False,
                    policy=FailurePolicy.FAIL,
                )
            except Exception:
                if self.failure_policy is FailurePolicy.FAIL:
                    raise
                return None  # Ignore: forward unmodified

        if pre_name is not None:
            # pre-hooks mutate the request before the runtime sees it
            hook_response = run_hook(pre_name)
            if hook_response is not None:
                self._merge(request, hook_response)

        backend_response = self.backend.handle(request)

        # bookkeeping after the runtime accepted the call
        if request.method == "RunPodSandbox":
            self.store.record_pod(pod)
        elif request.method == "StopPodSandbox":
            self.store.delete_pod(pod.uid)

        if post_name is not None:
            # post hooks run after the runtime acted; they never block
            # the already-completed call
            try:
                hook_response = run_hook(post_name) or hook_response
            except Exception:
                pass

        return CRIResponse(
            request=request,
            backend_response=backend_response,
            hook_response=hook_response,
        )

    @staticmethod
    def _merge(request: CRIRequest, response: Resources) -> None:
        """Overlay the hook's resource response onto the request (the
        reference's updateResource on the protobuf LinuxContainerResources)."""
        for field in dataclasses.fields(Resources):
            value = getattr(response, field.name)
            if value is not None:
                setattr(request.resources, field.name, value)
