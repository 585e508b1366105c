"""The in-process API-server bus: typed objects, watch/list, component
wiring (counterpart of ``koordinator_tpu/client``).

The components never talk to each other directly; they watch and patch
objects on the bus (:class:`APIServer`), a typed object store with
synchronous watch fan-out, through the informer-style adapters that
subscribe each component to the kinds it consumes and publish what it
produces.
"""

from koordinator_tpu_torch.client.bus import APIServer, Kind  # noqa: F401
from koordinator_tpu_torch.client.wiring import (  # noqa: F401
    wire_descheduler,
    wire_koordlet,
    wire_manager,
    wire_scheduler,
)
