"""The single cgroup write path (counterpart of
``koordinator_tpu/koordlet/resourceexecutor``)."""

from koordinator_tpu_torch.koordlet.resourceexecutor.executor import (
    CgroupUpdater,
    ResourceUpdateExecutor,
    merge_if_cfs_quota_larger,
    merge_if_cpuset_looser,
    merge_if_value_larger,
)

__all__ = [
    "CgroupUpdater",
    "ResourceUpdateExecutor",
    "merge_if_cfs_quota_larger",
    "merge_if_cpuset_looser",
    "merge_if_value_larger",
]
