"""NUMA-aware fine-grained CPU/resource allocation.

The port's own copy of ``koordinator_tpu/numa`` (host numpy, the same
integer semantics): the reference's NodeNUMAResource plugin and
scheduler-level topology manager (reference:
pkg/scheduler/plugins/nodenumaresource/, pkg/scheduler/frameworkext/
topologymanager/). Per-node CPU topologies are small fixed arrays, so the
inherently sequential greedy take() runs host-side on NumPy arrays (the
batched node-level Filter/Score stays on device, see SURVEY.md §7 step 6);
NUMA-node resource hints are bitmask arithmetic over at most 8 NUMA nodes.
"""

from koordinator_tpu_torch.numa.topology import (  # noqa: F401
    CPUBindPolicy,
    CPUExclusivePolicy,
    CPUTopology,
    NUMAAllocateStrategy,
)
from koordinator_tpu_torch.numa.accumulator import take_cpus, take_preferred_cpus  # noqa: F401
from koordinator_tpu_torch.numa.hints import (  # noqa: F401
    NUMATopologyHint,
    NUMATopologyPolicy,
    merge_hints,
)
from koordinator_tpu_torch.numa.manager import (  # noqa: F401
    NodeAllocation,
    PodAllocation,
    ResourceManager,
    TopologyOptions,
)
