"""The control-plane <-> solver boundary (counterpart of
``koordinator_tpu/service``): a length-prefixed npz protocol over a unix
or TCP socket, the admission gate, the multi-tenant lanes, the sidecar
server and its client, the sidecar's supervisor (``supervisor.py``), the
in-process failover (``failover.py``) and the warm pool
(``warmpool.py``)."""

from koordinator_tpu_torch.service.codec import (  # noqa: F401
    CodecError,
    FrameTooLarge,
    SolveRequest,
    SolveResponse,
    TruncatedFrame,
    decode_request,
    decode_response,
    encode_request,
    encode_response,
    read_frame,
    write_frame,
)
from koordinator_tpu_torch.service.admission import (  # noqa: F401
    AdmissionConfig,
    AdmissionGate,
    solve_coalesced,
)
from koordinator_tpu_torch.service.tenancy import (  # noqa: F401
    DEFAULT_TENANT,
    TenantRegistry,
    solve_tenant_lanes,
    tenant_wire_value,
)
from koordinator_tpu_torch.service.server import PlacementService  # noqa: F401
from koordinator_tpu_torch.service.client import (  # noqa: F401
    PlacementClient,
    RemoteSolver,
    SolverDeadlineExceeded,
    SolverOverloaded,
    SolverShuttingDown,
    SolverUnavailable,
)
