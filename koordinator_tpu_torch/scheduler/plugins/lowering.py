"""The per-cycle lowering the plugin chain shares (counterpart of
``koordinator_tpu/scheduler/plugins/lowering.py``).

Plugins read the same lowered arrays the batched solver does
(allocatable, requested, usage, the estimation corrections). They are
lowered once per cycle state, with the model's lowering configuration
(``LOWERING_KEY``, seeded by the Scheduler's framework), and cached under
``_VIEW_KEY``; the reservation restore and in-cycle reserves adjust a
per-node ``extra_used`` delta on top. Nothing is cached across cycles: a
Reserve in one cycle reaches the next through the scheduler cache's
assume.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from koordinator_tpu_torch.state.cluster import NodeArrays, lower_nodes

_VIEW_KEY = "__node_view__"
#: cycle-seed key: the ``lower_nodes`` kwargs (scaling factors, resource
#: weights, the LoadAware aggregated profile), from
#: ``PlacementModel.lowering_kwargs()``, so the chain lowers exactly as
#: the batched solver does
LOWERING_KEY = "__lowering_kwargs__"
#: cycle-seed key: the ``(thresholds[R], prod_thresholds[R])`` numpy
#: vectors the LoadAware filter runs with, read by the preemption path so
#: it never nominates a node the configured filter would reject
THRESHOLDS_KEY = "__loadaware_thresholds__"


@dataclasses.dataclass
class NodeView:
    arrays: NodeArrays
    index: Dict[str, int]
    #: per-node adjustment from the reservation restore and in-cycle
    #: reserves, added to ``arrays.used_req`` (numpy ``[R]`` vectors)
    extra_used: Dict[str, np.ndarray]


def node_view(state, snapshot) -> NodeView:
    view = state.get(_VIEW_KEY)
    if view is None or view.arrays.n != len(snapshot.nodes):
        arrays = lower_nodes(snapshot, **(state.get(LOWERING_KEY) or {}))
        view = NodeView(arrays=arrays, index=arrays.index(), extra_used={})
        state[_VIEW_KEY] = view
    return view
