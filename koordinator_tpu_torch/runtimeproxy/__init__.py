"""koord-runtime-proxy: the CRI interposer between kubelet and the
container runtime (counterpart of ``koordinator_tpu/runtimeproxy/``).

Reference: pkg/runtimeproxy/ (SURVEY.md §2.5, §3.5) —
``server/cri/criserver.go`` intercepts the resource-relevant CRI calls,
runs the koordlet RuntimeHookServer pre/post, merges the hook response
into the runtime request, and transparently forwards everything else;
``store/`` keeps pod/container metadata across calls (rebuilt from the
backend on startup, the failOver path); ``config`` failure policy decides
whether hook errors fail the CRI call.
"""

from koordinator_tpu_torch.runtimeproxy.criserver import (  # noqa: F401
    BackendRuntime,
    CRIRequest,
    CRIResponse,
    RuntimeManagerCriServer,
    RuntimeProxyStore,
)
