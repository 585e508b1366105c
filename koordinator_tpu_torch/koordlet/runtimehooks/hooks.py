"""Hook registry: named hooks per lifecycle stage.

Reference: pkg/koordlet/runtimehooks/hooks/hooks.go — Register(stage,
name, description, fn) builds a per-stage hook list (:47), RunHooks
(:82) invokes them in registration order with a failure policy (Ignore
continues, Fail aborts). The registry here is instance-based so tests
and multiple agents compose; a module-level default mirrors the
reference's global.

Counterpart of ``koordinator_tpu/koordlet/runtimehooks/hooks.py``: host
work in files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, List, Optional

from koordinator_tpu_torch.koordlet.runtimehooks.protocol import HooksProtocol


class Stage(enum.Enum):
    """runtimeproxy/config RuntimeHookType (hooks.go:104-112)."""

    PRE_RUN_POD_SANDBOX = "PreRunPodSandbox"
    PRE_CREATE_CONTAINER = "PreCreateContainer"
    PRE_START_CONTAINER = "PreStartContainer"
    POST_START_CONTAINER = "PostStartContainer"
    POST_STOP_CONTAINER = "PostStopContainer"
    POST_STOP_POD_SANDBOX = "PostStopPodSandbox"
    PRE_UPDATE_CONTAINER_RESOURCES = "PreUpdateContainerResources"


class FailurePolicy(enum.Enum):
    IGNORE = "Ignore"   # log and continue (default)
    FAIL = "Fail"       # abort the stage on first error


HookFn = Callable[[HooksProtocol], None]


@dataclasses.dataclass
class Hook:
    name: str
    stage: Stage
    description: str
    fn: HookFn


class HookRegistry:
    """Per-stage ordered hook lists (hooks.go:47-100)."""

    def __init__(self):
        self._stages: Dict[Stage, List[Hook]] = {s: [] for s in Stage}

    def register(self, stage: Stage, name: str, description: str,
                 fn: HookFn) -> Hook:
        for hook in self._stages[stage]:
            if hook.name == name:
                raise ValueError(
                    f"hook {name} already registered at stage {stage.value}"
                )
        hook = Hook(name=name, stage=stage, description=description, fn=fn)
        self._stages[stage].append(hook)
        return hook

    def hooks_by_stage(self, stage: Stage) -> List[Hook]:
        return list(self._stages[stage])

    def stages_with_hooks(self) -> List[Stage]:
        """hooks.go:117 GetStages: stages that have registered hooks."""
        return [s for s, hooks in self._stages.items() if hooks]

    def run_hooks(
        self,
        stage: Stage,
        proto: HooksProtocol,
        fail_policy: FailurePolicy = FailurePolicy.IGNORE,
        errors: Optional[List[Exception]] = None,
    ) -> None:
        """hooks.go:82 RunHooks: invoke the stage's hooks in order; on
        error either collect-and-continue (Ignore) or re-raise (Fail)."""
        for hook in self._stages[stage]:
            try:
                hook.fn(proto)
            except Exception as e:  # noqa: BLE001 - hook isolation
                if fail_policy is FailurePolicy.FAIL:
                    raise
                if errors is not None:
                    errors.append(e)


#: module default, mirroring the reference's global registry
DEFAULT_REGISTRY = HookRegistry()
