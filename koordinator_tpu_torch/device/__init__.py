"""Device (GPU/RDMA/FPGA) partial + multi-device allocation.

The port's own copy of ``koordinator_tpu/device`` (host Python): the
reference's DeviceShare plugin
(pkg/scheduler/plugins/deviceshare/): per-node device inventories with
PCIe/NUMA topology, percentage-share device resources, virtual-function
allocation, and PCIe/NUMA joint allocation. Per-node minor counts are tiny
(≤16), so allocation runs host-side; the node fan-out stays in the batched
solver.
"""

from koordinator_tpu_torch.device.cache import (  # noqa: F401
    DeviceResourceName,
    DeviceType,
    NodeDevice,
    NodeDeviceCache,
    VirtualFunction,
)
from koordinator_tpu_torch.device.allocator import (  # noqa: F401
    AutopilotAllocator,
    DeviceAllocation,
    DeviceHint,
    DeviceUnschedulable,
    JointAllocate,
    normalize_device_requests,
)
