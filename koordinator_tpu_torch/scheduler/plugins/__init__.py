"""The built-in scheduler plugins (counterpart of
``koordinator_tpu/scheduler/plugins``).

Each implements the host extension points (``scheduler/framework.py``)
of the plugin chain; the hot math goes through the same canonical-unit
functions and the same lowering the batched solver uses, so the two
paths cannot drift.
"""

from koordinator_tpu_torch.scheduler.plugins.fit import NodeResourcesFit  # noqa: F401
from koordinator_tpu_torch.scheduler.plugins.loadaware import LoadAwareScheduling  # noqa: F401
from koordinator_tpu_torch.scheduler.plugins.elasticquota import ElasticQuotaPlugin  # noqa: F401
from koordinator_tpu_torch.scheduler.plugins.coscheduling import CoschedulingPlugin  # noqa: F401
from koordinator_tpu_torch.scheduler.plugins.reservation import ReservationPlugin  # noqa: F401
from koordinator_tpu_torch.scheduler.plugins.nodenumaresource import (  # noqa: F401
    NodeNUMAResourcePlugin,
)
from koordinator_tpu_torch.scheduler.plugins.deviceshare import DeviceSharePlugin  # noqa: F401
from koordinator_tpu_torch.scheduler.plugins.defaultprebind import DefaultPreBind  # noqa: F401
