"""Runtime hook server: the NRI/proxy-equivalent event seam.

Reference: pkg/koordlet/runtimehooks/nri/server.go (containerd NRI v0.3)
and proxyserver/ (UDS gRPC for koord-runtime-proxy) — a runtime delivers
pod/container lifecycle events; the server runs the stage's hooks and
returns (and in standalone mode applies) the cgroup mutations.

The transport here is an in-process call surface: the CRI-interposer
component (``runtimeproxy``) and the PLEG both drive it.
``apply=True`` ("standalone" reconciler-backed mode) writes the response
through the executor immediately; ``apply=False`` returns the mutation
for the interposer to merge into the runtime request (the NRI
adjustment path).

Counterpart of ``koordinator_tpu/koordlet/runtimehooks/server.py``: host
work in files, bit for bit the reference's.
"""

from __future__ import annotations

from typing import Optional

from koordinator_tpu_torch.koordlet.metricsadvisor.framework import PodMeta
from koordinator_tpu_torch.koordlet.resourceexecutor import ResourceUpdateExecutor
from koordinator_tpu_torch.koordlet.runtimehooks.hooks import (
    FailurePolicy,
    HookRegistry,
    Stage,
)
from koordinator_tpu_torch.koordlet.runtimehooks.protocol import (
    ContainerContext,
    PodContext,
    Resources,
)


class RuntimeHookServer:
    """Dispatches lifecycle events to hooks (nri/server.go:
    RunPodSandbox/CreateContainer/UpdateContainer handlers)."""

    def __init__(
        self,
        registry: HookRegistry,
        executor: Optional[ResourceUpdateExecutor] = None,
        fail_policy: FailurePolicy = FailurePolicy.IGNORE,
    ):
        self.registry = registry
        self.executor = executor
        self.fail_policy = fail_policy

    def _finish(self, ctx, apply: bool) -> Resources:
        if apply and self.executor is not None:
            ctx.reconciler_done(self.executor)
        return ctx.response

    # -- pod events ----------------------------------------------------------

    def run_pod_sandbox(self, pod: PodMeta, apply: bool = True,
                        policy: Optional[FailurePolicy] = None) -> Resources:
        ctx = PodContext.from_meta(pod)
        self.registry.run_hooks(
            Stage.PRE_RUN_POD_SANDBOX, ctx, policy or self.fail_policy
        )
        return self._finish(ctx, apply)

    def stop_pod_sandbox(self, pod: PodMeta, apply: bool = True,
                         policy: Optional[FailurePolicy] = None) -> Resources:
        ctx = PodContext.from_meta(pod)
        self.registry.run_hooks(
            Stage.POST_STOP_POD_SANDBOX, ctx, policy or self.fail_policy
        )
        return self._finish(ctx, apply)

    # -- container events ----------------------------------------------------

    def create_container(
        self, pod: PodMeta, container: str, apply: bool = True,
        policy: Optional[FailurePolicy] = None,
    ) -> Resources:
        ctx = ContainerContext.from_meta(pod, container)
        self.registry.run_hooks(
            Stage.PRE_CREATE_CONTAINER, ctx, policy or self.fail_policy
        )
        return self._finish(ctx, apply)

    def start_container(
        self, pod: PodMeta, container: str, apply: bool = True,
        policy: Optional[FailurePolicy] = None,
    ) -> Resources:
        ctx = ContainerContext.from_meta(pod, container)
        self.registry.run_hooks(
            Stage.PRE_START_CONTAINER, ctx, policy or self.fail_policy
        )
        return self._finish(ctx, apply)

    def update_container_resources(
        self, pod: PodMeta, container: str, apply: bool = True,
        policy: Optional[FailurePolicy] = None,
    ) -> Resources:
        ctx = ContainerContext.from_meta(pod, container)
        self.registry.run_hooks(
            Stage.PRE_UPDATE_CONTAINER_RESOURCES, ctx, policy or self.fail_policy
        )
        return self._finish(ctx, apply)

    def post_start_container(
        self, pod: PodMeta, container: str, apply: bool = True,
        policy: Optional[FailurePolicy] = None,
    ) -> Resources:
        ctx = ContainerContext.from_meta(pod, container)
        self.registry.run_hooks(
            Stage.POST_START_CONTAINER, ctx, policy or self.fail_policy
        )
        return self._finish(ctx, apply)

    def stop_container(
        self, pod: PodMeta, container: str, apply: bool = True,
        policy: Optional[FailurePolicy] = None,
    ) -> Resources:
        ctx = ContainerContext.from_meta(pod, container)
        self.registry.run_hooks(
            Stage.POST_STOP_CONTAINER, ctx, policy or self.fail_policy
        )
        return self._finish(ctx, apply)
