"""Feature gates (counterpart of ``koordinator_tpu/features.py``: the
``FeatureGate`` registry, the scheduler's gates, the manager's and the
koordlet's).

Gates parse the k8s-style ``--feature-gates=Name=true,Other=false`` spec
and components consult them at construction time.
``cmd/scheduler.build_scheduler`` reads ``BatchedPlacement`` (False:
per-pod plugin-chain rounds) and ``ElasticQuotaPreemption``;
``cmd/manager.build_manager`` reads the six webhook gates of
``MANAGER_GATES``; ``cmd/koordlet.build_koordlet`` reads the 13 gates of
``KOORDLET_GATES``. Only the names some code reads are registered: a gate
is added with the code that reads it, and naming any other raises.
"""

from __future__ import annotations

from typing import Dict, Mapping


class FeatureGate:
    """A mutable gate registry (componentbase featuregate.FeatureGate)."""

    def __init__(self, defaults: Mapping[str, bool]):
        self._defaults: Dict[str, bool] = dict(defaults)
        self._overrides: Dict[str, bool] = {}

    def enabled(self, feature: str) -> bool:
        if feature not in self._defaults:
            raise KeyError(f"unknown feature gate {feature!r}")
        return self._overrides.get(feature, self._defaults[feature])

    def set_from_spec(self, spec: str) -> None:
        """Parse "A=true,B=false" (the --feature-gates flag format).
        Atomic: an invalid spec leaves the registry untouched."""
        if not spec:
            return
        parsed: Dict[str, bool] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"invalid feature gate spec {part!r}")
            name, raw = part.split("=", 1)
            name = name.strip()
            raw = raw.strip().lower()
            if raw not in ("true", "false"):
                raise ValueError(f"invalid feature gate value {part!r}")
            if name not in self._defaults:
                raise KeyError(f"unknown feature gate {name!r}")
            parsed[name] = raw == "true"
        self._overrides.update(parsed)

    def copy(self) -> "FeatureGate":
        """A fresh gate with this registry's effective values as defaults
        (``build_scheduler`` copies the module registry, so one build's
        overrides never leak into the next)."""
        return FeatureGate(self.as_dict())

    def as_dict(self) -> Dict[str, bool]:
        return {name: self.enabled(name) for name in self._defaults}


#: the scheduler gates the port reads: the batched device round (False:
#: per-pod plugin-chain cycles) and ElasticQuota's PostFilter preemption.
#: The reference's upstream gates (scheduler_features.go:32-59) change
#: nothing here yet, so they are not registered and naming one raises.
SCHEDULER_GATES = FeatureGate({
    "BatchedPlacement": True,
    "ElasticQuotaPreemption": True,
})

#: the manager gates ``cmd/manager.build_manager`` reads, each with the
#: reference's default (features.go:28-90): which admission webhooks the
#: manager serves. The reference's other manager gates change nothing
#: here, so they are not registered and naming one raises.
MANAGER_GATES = FeatureGate({
    "PodMutatingWebhook": True,
    "PodValidatingWebhook": True,
    "ElasticValidatingWebhook": True,
    "NodeMutatingWebhook": False,
    "NodeValidatingWebhook": False,
    "ConfigMapValidatingWebhook": False,
})

#: the koordlet gates ``cmd/koordlet.build_koordlet`` reads, each with the
#: reference's default (koordlet_features.go:154-173): which collectors and
#: QoS strategies the agent registers, and whether it keeps an auditor.
#: Five of the reference's 18 wait: ``AuditEventsHTTPHandler``,
#: ``BECPUManager``, ``NodeTopologyReport``, ``Libpfm4`` and
#: ``HugePageReport``. No code of either package reads them (the NRT
#: reporter always runs, the perf reader is ``native/perf_group.cpp``
#: rather than libpfm4, and the debug mux always serves the audit log),
#: so they are not registered and naming one raises.
KOORDLET_GATES = FeatureGate({
    "AuditEvents": False,
    "BECPUSuppress": True,
    "BECPUEvict": False,
    "BEMemoryEvict": False,
    "CPUBurst": True,
    "SystemConfig": False,
    "RdtResctrl": True,
    "CgroupReconcile": False,
    "Accelerators": False,
    "CPICollector": False,
    "PSICollector": False,
    "BlkIOReconcile": False,
    "ColdPageCollector": False,
})
