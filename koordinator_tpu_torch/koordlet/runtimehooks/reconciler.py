"""Reconciler mode: periodically (re-)apply hook outputs to cgroupfs.

Reference: pkg/koordlet/runtimehooks/reconciler/reconciler.go — where no
NRI/proxy interposition is available (or to heal drift), the reconciler
walks kube-QoS dirs, every pod, and every container on informer events
and applies the same hook-derived cgroup values through the shared
executor (:244 Run, :272 reconcileKubeQOSCgroup, :313
reconcilePodCgroup).

Writes go through ``leveled_update_batch`` so the cgroup hierarchy stays
consistent mid-transition (parents loosened before children tighten).

Counterpart of ``koordinator_tpu/koordlet/runtimehooks/reconciler.py``:
host work in files, bit for bit the reference's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from koordinator_tpu_torch.koordlet.metricsadvisor.framework import PodMeta
from koordinator_tpu_torch.koordlet.resourceexecutor import (
    CgroupUpdater,
    ResourceUpdateExecutor,
)
from koordinator_tpu_torch.koordlet.runtimehooks.groupidentity import BvtPlugin
from koordinator_tpu_torch.koordlet.runtimehooks.hooks import (
    FailurePolicy,
    HookRegistry,
    Stage,
)
from koordinator_tpu_torch.koordlet.runtimehooks.protocol import (
    ContainerContext,
    KubeQOS,
    KubeQOSContext,
    PodContext,
)


class Reconciler:
    """Drives hook stages over the current pod set."""

    def __init__(
        self,
        registry: HookRegistry,
        executor: ResourceUpdateExecutor,
        bvt_plugin: Optional[BvtPlugin] = None,
    ):
        self.registry = registry
        self.executor = executor
        self.bvt_plugin = bvt_plugin

    def reconcile(self, pods: Sequence[PodMeta]) -> int:
        """One reconcile pass; returns the number of cgroup writes.

        Levels: kube-QoS dirs -> pods -> containers (reconciler.go
        KubeQOSLevel/PodLevel/ContainerLevel ordering).
        """
        qos_level: List[CgroupUpdater] = []
        pod_level: List[CgroupUpdater] = []
        container_level: List[CgroupUpdater] = []

        if self.bvt_plugin is not None and self.bvt_plugin.rule is not None:
            for kq in KubeQOS:
                ctx = KubeQOSContext(kube_qos=kq)
                ctx.response.cpu_bvt = self.bvt_plugin.rule.kube_qos_dir_bvt(
                    kq
                )
                qos_level.extend(ctx.updaters())

        for pod in pods:
            pod_ctx = PodContext.from_meta(pod)
            self.registry.run_hooks(
                Stage.PRE_RUN_POD_SANDBOX, pod_ctx, FailurePolicy.IGNORE
            )
            pod_level.extend(pod_ctx.updaters())
            for container in pod.containers:
                c_ctx = ContainerContext.from_meta(pod, container)
                self.registry.run_hooks(
                    Stage.PRE_CREATE_CONTAINER, c_ctx, FailurePolicy.IGNORE
                )
                container_level.extend(c_ctx.updaters())

        return self.executor.leveled_update_batch(
            [qos_level, pod_level, container_level]
        )
