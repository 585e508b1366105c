"""runtimehooks: pod-lifecycle QoS actuation (the decision->cgroup path).

Reference: pkg/koordlet/runtimehooks/ — the koordlet subsystem that turns
scheduler decisions (QoS class labels, cpuset annotations, batch
resources) into cgroup state at pod/container lifecycle events, via
three delivery modes: NRI server, runtime-proxy gRPC, and a reconciler.

Here: an instance-based hook registry (hooks.py), typed protocol
contexts (protocol.py), the three core hook plugins (groupidentity bvt,
cpuset pinning, batchresource limits), a reconciler that heals cgroup
drift from informer state, and an in-process server seam for the CRI
interposer. ``RuntimeHooks`` wires them against a states informer +
executor.

Counterpart of ``koordinator_tpu/koordlet/runtimehooks/__init__.py``:
host work in files, bit for bit the reference's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from koordinator_tpu_torch.koordlet.metricsadvisor.framework import (
    ContainerBatchResources,
    PodMeta,
)
from koordinator_tpu_torch.koordlet.resourceexecutor import ResourceUpdateExecutor
from koordinator_tpu_torch.koordlet.runtimehooks.batchresource import (
    BatchResourcePlugin,
)
from koordinator_tpu_torch.koordlet.runtimehooks.cpunormalization import (
    CPUNormalizationPlugin,
)
from koordinator_tpu_torch.koordlet.runtimehooks.cpuset import (
    CpusetPlugin,
    NodeTopoInfo,
)
from koordinator_tpu_torch.koordlet.runtimehooks.devices import DeviceEnvPlugin
from koordinator_tpu_torch.koordlet.runtimehooks.terwayqos import TerwayQosPlugin
from koordinator_tpu_torch.koordlet.runtimehooks.groupidentity import (
    BvtPlugin,
    BvtRule,
    parse_rule,
)
from koordinator_tpu_torch.koordlet.runtimehooks.hooks import (
    DEFAULT_REGISTRY,
    FailurePolicy,
    Hook,
    HookRegistry,
    Stage,
)
from koordinator_tpu_torch.koordlet.runtimehooks.protocol import (
    ContainerContext,
    HooksProtocol,
    KUBE_QOS_DIR,
    KubeQOS,
    KubeQOSContext,
    PodContext,
    Resources,
    kube_qos_by_cgroup_parent,
    milli_cpu_to_quota,
    milli_cpu_to_shares,
)
from koordinator_tpu_torch.koordlet.runtimehooks.reconciler import Reconciler
from koordinator_tpu_torch.koordlet.runtimehooks.nri import NriServer
from koordinator_tpu_torch.koordlet.runtimehooks.server import RuntimeHookServer
from koordinator_tpu_torch.koordlet.statesinformer.states_informer import (
    StateKind,
    StatesInformer,
)
from koordinator_tpu_torch.manager.sloconfig import NodeSLOSpec

__all__ = [
    "BatchResourcePlugin",
    "BvtPlugin",
    "BvtRule",
    "CPUNormalizationPlugin",
    "DeviceEnvPlugin",
    "TerwayQosPlugin",
    "ContainerBatchResources",
    "ContainerContext",
    "CpusetPlugin",
    "DEFAULT_REGISTRY",
    "FailurePolicy",
    "Hook",
    "HookRegistry",
    "HooksProtocol",
    "KUBE_QOS_DIR",
    "KubeQOS",
    "KubeQOSContext",
    "NodeTopoInfo",
    "PodContext",
    "Reconciler",
    "Resources",
    "NriServer",
    "RuntimeHookServer",
    "RuntimeHooks",
    "Stage",
    "kube_qos_by_cgroup_parent",
    "milli_cpu_to_quota",
    "milli_cpu_to_shares",
    "parse_rule",
]


class RuntimeHooks:
    """Top-level wiring (reference: runtimehooks.go NewRuntimeHook):
    registers the standard plugins on a fresh registry, subscribes to
    informer NodeSLO/pod changes, exposes the server + reconciler."""

    def __init__(
        self,
        informer: StatesInformer,
        executor: ResourceUpdateExecutor,
        registry: Optional[HookRegistry] = None,
    ):
        self.registry = registry or HookRegistry()
        self.executor = executor
        self.informer = informer

        self.groupidentity = BvtPlugin()
        self.cpuset = CpusetPlugin()
        self.batchresource = BatchResourcePlugin()
        self.devices = DeviceEnvPlugin()
        self.cpunormalization = CPUNormalizationPlugin()
        self.terwayqos = TerwayQosPlugin(
            root_path=executor.config.terway_qos_root,
            auditor=executor.auditor,
        )
        self.groupidentity.register(self.registry)
        self.cpuset.register(self.registry)
        self.batchresource.register(self.registry)
        self.devices.register(self.registry)
        self.cpunormalization.register(self.registry)

        self.reconciler = Reconciler(
            self.registry, executor, bvt_plugin=self.groupidentity
        )
        self.server = RuntimeHookServer(self.registry, executor)

        informer.register_callback(StateKind.NODE_SLO, self._on_node_slo)
        informer.register_callback(StateKind.PODS, self._on_pods)
        informer.register_callback(StateKind.NODE, self._on_node)
        # arm the rules from whatever the informer already holds
        self.groupidentity.update_rule(informer.get_node_slo())
        self.cpunormalization.update_rule(informer.get_node())
        self.terwayqos.update_node_slo(informer.get_node_slo())
        self.terwayqos.update_pods(informer.running_pods())

    # -- informer callbacks --------------------------------------------------

    def _on_node_slo(self, kind: StateKind, slo: NodeSLOSpec) -> None:
        if self.groupidentity.update_rule(slo):
            # rule changed: re-actuate every kube-QoS dir + pod
            # (rule.go:148 ruleUpdateCb)
            self.groupidentity.rule_update(
                self.informer.running_pods(), self.executor
            )
        self.terwayqos.update_node_slo(slo)

    def _on_pods(self, kind: StateKind, pods: Sequence[PodMeta]) -> None:
        self.terwayqos.update_pods(pods)
        self.reconcile()
        self._finish_restore_if_settled(pods)

    def _on_node(self, kind: StateKind, node) -> None:
        # cpu-normalization ratio rides the node annotation (the rule's
        # RegisterTypeNodeMetadata parse); a change re-actuates quotas,
        # and a removal restores spec quotas (one-shot, but kept armed
        # while the informer's pod view is empty so a pod missing during
        # the rule change still gets restored on its next PODS update)
        if self.cpunormalization.update_rule(node):
            self.reconcile()
            self._finish_restore_if_settled(self.informer.running_pods())

    def _finish_restore_if_settled(self, pods) -> None:
        if self.cpunormalization.restoring and len(pods) > 0:
            self.cpunormalization.finish_restore()

    # -- public surface ------------------------------------------------------

    def set_node_topo(self, topo: NodeTopoInfo) -> None:
        """Feed share pools / kubelet policy (reference: cpuset rule from
        the NodeResourceTopology CR). A changed rule re-actuates every
        pod immediately (cpuset/rule.go:205 ruleUpdateCb)."""
        if self.cpuset.update_rule(topo):
            self.reconcile()

    def reconcile(self) -> int:
        return self.reconciler.reconcile(self.informer.running_pods())

    def attach_nri(self, pleg, events=None, disable_stages=None):
        """Enable NRI mode: subscribe the hook server to a PLEG event
        stream (nri/server.go); returns the attached NriServer."""
        return NriServer(
            self.server, self.informer, events=events,
            disable_stages=disable_stages,
        ).attach(pleg)
