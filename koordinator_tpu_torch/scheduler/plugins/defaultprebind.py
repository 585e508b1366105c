"""DefaultPreBind: the cycle's accumulated object patches, applied once at
PreBind (counterpart of
``koordinator_tpu/scheduler/plugins/defaultprebind.py``; reference
pkg/scheduler/plugins/defaultprebind/plugin.go): the consumed
reservation's name and the resource status onto the pod's annotations."""

from __future__ import annotations

import json

from koordinator_tpu_torch.apis.extension import (
    ANNOTATION_RESERVATION_ALLOCATED,
    ANNOTATION_RESOURCE_STATUS,
)
from koordinator_tpu_torch.scheduler.framework import (
    CycleState,
    Plugin,
    Status,
)


class DefaultPreBind(Plugin):
    name = "DefaultPreBind"

    def score_weight(self) -> int:
        return 0

    def pre_bind(self, state: CycleState, snapshot, pod, node) -> Status:
        if state.get("reservation_allocated"):
            pod.annotations[ANNOTATION_RESERVATION_ALLOCATED] = state[
                "reservation_allocated"]
        status = state.get("resource_status")
        if status:
            pod.annotations[ANNOTATION_RESOURCE_STATUS] = json.dumps(status)
        return Status.success()
