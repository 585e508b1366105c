"""The pod lifecycle event generator (counterpart of
``koordinator_tpu/koordlet/pleg``)."""

from koordinator_tpu_torch.koordlet.pleg.pleg import PLEG, PodLifecycleEvent

__all__ = ["PLEG", "PodLifecycleEvent"]
