"""Descheduler: load-aware rebalancing + reservation-first migration
(counterpart of ``koordinator_tpu/descheduler``).

A rebuild of the reference pkg/descheduler/: its own plugin
framework (Deschedule/Balance extension points), the LowNodeLoad balance
plugin (node classification vectorized over the whole pool via
``ops.rebalance``), the PodMigrationJob controller (reservation-first
migrate state machine) and the arbitrator (sort + group-limit filters).
"""

from koordinator_tpu_torch.descheduler.framework import (  # noqa: F401
    BalancePlugin,
    DeschedulePlugin,
    Descheduler,
    DirectEvictor,
    EvictionLimiter,
    MigrationEvictor,
    Profile,
)
from koordinator_tpu_torch.descheduler.anomaly import BasicDetector  # noqa: F401
from koordinator_tpu_torch.descheduler.loadaware import (  # noqa: F401
    LowNodeLoad,
    LowNodeLoadArgs,
    NodePool,
)
from koordinator_tpu_torch.descheduler.migration import (  # noqa: F401
    Arbitrator,
    MigrationController,
)
