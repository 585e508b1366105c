"""koord-manager's central controllers (counterpart of
``koordinator_tpu/manager``): the noderesource overcommit controller with
the colocation strategy it reads, the nodemetric collect policy, the
NodeSLO renderer and the recommendation controller. The admission
webhooks it serves live in ``koordinator_tpu_torch.webhook``, wired by
``cmd/manager.py``.

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
from koordinator_tpu_torch.manager.nodemetric import node_metric_collect_policy
from koordinator_tpu_torch.manager.nodeslo import NodeSLOController

__all__ = [
    "ColocationStrategy",
    "NodeSLOSpec",
    "default_node_slo_spec",
    "NodeResourceController",
    "node_metric_collect_policy",
    "NodeSLOController",
]
