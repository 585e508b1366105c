"""koord-manager's central controllers (counterpart of
``koordinator_tpu/manager``, cut to the noderesource overcommit
controller and the colocation strategy it reads; the nodemetric collect
policy and the NodeSLO renderer are not ported yet).

The noderesource controller lowers the whole cluster to arrays and
computes every node's batch and mid allocatable in one step of torch
ops on its device (``ops/overcommit.py``).
"""

from koordinator_tpu_torch.manager.sloconfig import ColocationStrategy
from koordinator_tpu_torch.manager.noderesource import NodeResourceController

__all__ = [
    "ColocationStrategy",
    "NodeResourceController",
]
