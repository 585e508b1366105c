"""OS abstraction: typed cgroup v1/v2 resource registry.

Reference: pkg/koordlet/util/system/ (cgroup_resource.go, cgroup.go,
cgroup2.go). All paths resolve under a configurable root so tests run
against a fake cgroupfs tree in a temp dir (the reference's testutil
path-redirection pattern).

Counterpart of ``koordinator_tpu/koordlet/system/__init__.py``: host
work in numpy and files, bit for bit the reference's.
"""

from koordinator_tpu_torch.koordlet.system.cgroup import (
    CgroupResource,
    CgroupVersion,
    SystemConfig,
    convert_cpu_shares_to_weight,
    convert_cpu_weight_to_shares,
    get_resource,
    known_resources,
)
from koordinator_tpu_torch.koordlet.system.core_sched import (
    CoreSched,
    FakeKernel,
)
from koordinator_tpu_torch.koordlet.system.resctrl import (
    ResctrlFS,
    ResctrlSchemata,
    calculate_cat_l3_mask,
    calculate_mba,
    detect_vendor,
    resctrl_root,
)

__all__ = [
    "CgroupResource",
    "CgroupVersion",
    "CoreSched",
    "FakeKernel",
    "ResctrlFS",
    "ResctrlSchemata",
    "SystemConfig",
    "calculate_cat_l3_mask",
    "calculate_mba",
    "convert_cpu_shares_to_weight",
    "convert_cpu_weight_to_shares",
    "detect_vendor",
    "get_resource",
    "known_resources",
    "resctrl_root",
]
