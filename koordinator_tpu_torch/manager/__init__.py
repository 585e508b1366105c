"""koord-manager's central controllers (counterpart of
``koordinator_tpu/manager``, cut to the noderesource overcommit
controller with the colocation strategy it reads, and the NodeSLO
renderer; the nodemetric collect policy is not ported yet).

The noderesource controller lowers the whole cluster to arrays and
computes every node's batch and mid allocatable in one step of torch
ops on its device (``ops/overcommit.py``).
"""

from koordinator_tpu_torch.manager.sloconfig import (
    ColocationStrategy,
    NodeSLOSpec,
    default_node_slo_spec,
)
from koordinator_tpu_torch.manager.noderesource import NodeResourceController
from koordinator_tpu_torch.manager.nodeslo import NodeSLOController

__all__ = [
    "ColocationStrategy",
    "NodeSLOSpec",
    "default_node_slo_spec",
    "NodeResourceController",
    "NodeSLOController",
]
