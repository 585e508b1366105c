"""The placement model: typed snapshot in, committed placements out."""

from koordinator_tpu_torch.models.placement import PlacementModel, ScheduleResult

__all__ = ["PlacementModel", "ScheduleResult"]
