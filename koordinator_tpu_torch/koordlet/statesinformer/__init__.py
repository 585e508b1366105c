"""The node agent's state and its reporters (counterpart of
``koordinator_tpu/koordlet/statesinformer``)."""

from koordinator_tpu_torch.koordlet.statesinformer.states_informer import (
    StateKind,
    StatesInformer,
)
from koordinator_tpu_torch.koordlet.statesinformer.nodemetric_reporter import (
    NodeMetricReporter,
)
from koordinator_tpu_torch.koordlet.statesinformer.reporters import (
    DeviceReporter,
    NodeTopologyReporter,
    PodsInformer,
    pod_meta_from_spec,
)

__all__ = [
    "StateKind",
    "StatesInformer",
    "NodeMetricReporter",
    "DeviceReporter",
    "NodeTopologyReporter",
    "PodsInformer",
    "pod_meta_from_spec",
]
