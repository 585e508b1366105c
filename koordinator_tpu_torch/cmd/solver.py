"""koord-solver: the placement-solver sidecar on one device (counterpart
of ``koordinator_tpu/cmd/solver.py``).

    python -m koordinator_tpu_torch.cmd.solver --listen ./solver.sock

The scheduler speaks the framed npz protocol to this process
(``service/client.RemoteSolver``, or the reference's, behind
``--placement-backend=sidecar``), which keeps the kernel library built
and loaded across control-plane restarts. It runs on ``cuda``
(``--device`` names another).

``--debug-port`` serves the debug mux (``utils/debug_http.py``):
``/healthz``, ``/metrics`` (the admission, device-observatory and
working-set series), ``/apis/v1/plugins/{solver,trace,
device-observatory,workingset}``, ``/debug/trace``, ``/debug/device``
and ``/debug/profile?rounds=K`` (a ``torch.profiler`` window over the
next K solves, written under ``--profile-dir``). ``--hbm-budget-bytes``
sets the working set's budget for the staged tenant bases
(``state/workingset.py``).

Before its socket opens, the solver restores the warm pool
(``service/warmpool.py``; the store is ``KTPU_COMPILATION_CACHE_DIR``,
empty disables it, and so does ``--no-warm-pool``): the kernel library
from the store when ``_build/`` lacks it, then a CUDA graph captured for
each signature a predecessor persisted, so a respawned sidecar's first
solve, usually a reconnecting scheduler's full restage under a deadline,
replays one. It keeps persisting new signatures in the background, and
its debug mux serves the pool's status at ``/apis/v1/plugins/warm-pool``.
On a CUDA device it then loads the kernel library (building it with
``nvcc`` only when no build of these sources is there) and runs
``service/server.warm_up`` (one small solve on each kernel route: the
lazily loaded kernel and torch-op modules).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional, Tuple, Union

def parse_address(spec: str) -> Union[str, Tuple[str, int]]:
    """``host:port`` -> TCP tuple; anything else is a UDS path."""
    if ":" in spec and not spec.startswith("/"):
        host, _, port = spec.rpartition(":")
        return (host or "127.0.0.1", int(port))
    return spec


def start_debug_server(service, port: int, warm_pool=None):
    """The solver's debug mux on ``port`` (0 picks a free one) over
    ``service`` (a started ``PlacementService``), with the ``warm-pool``
    section when ``warm_pool`` is given; returns the started
    ``DebugHTTPServer``."""
    from koordinator_tpu_torch.metrics.components import (
        DEVICE_METRICS,
        SOLVER_METRICS,
        WORKINGSET_METRICS,
    )
    from koordinator_tpu_torch.metrics.registry import MergedGatherer
    from koordinator_tpu_torch.obs.device import DEVICE_OBS
    from koordinator_tpu_torch.obs.trace import TRACER
    from koordinator_tpu_torch.scheduler.monitor import DebugServices
    from koordinator_tpu_torch.state.workingset import WORKING_SET
    from koordinator_tpu_torch.utils.debug_http import DebugHTTPServer

    def profile(rounds: int) -> dict:
        # a window on the served device; a PyTorch without CUDA
        # profiling is a permanent incapacity (501), not a retry
        try:
            return DEVICE_OBS.request_profile(rounds, device=service.device)
        except RuntimeError as e:
            return {"unsupported": True, "error": str(e)}

    services = DebugServices()
    # the gate (lane depths, coalesce ratio, shed counts), the device
    # and the working set in one GET; /metrics serves the same as series
    services.register("solver", service.status)
    services.register("trace", TRACER.status)
    services.register("device-observatory", DEVICE_OBS.status)
    services.register("workingset", WORKING_SET.status)
    if warm_pool is not None:
        # did this child restore warm, and is its store healthy (the
        # supervisor's debug_port_warm_outcome reads it)
        services.register("warm-pool", warm_pool.status)
    return DebugHTTPServer(
        services=services,
        metrics=MergedGatherer(
            [SOLVER_METRICS, DEVICE_METRICS, WORKINGSET_METRICS]),
        tracer=TRACER, port=port,
        device=DEVICE_OBS.debug_payload,
        profile=profile,
    ).start()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("koord-solver")
    parser.add_argument(
        "--listen",
        default=os.path.join(tempfile.gettempdir(), "koord-solver.sock"),
        help="UDS path or host:port to serve the solve protocol on "
             "(default: koord-solver.sock in the temporary directory)")
    parser.add_argument(
        "--secret-file", default=None,
        help="path to a shared secret required from every peer")
    parser.add_argument("--once", action="store_true",
                        help="start, report readiness, and exit (smoke)")
    parser.add_argument(
        "--ready-file", default=None,
        help="write this file (containing the pid) once the solve socket "
             "is accepting")
    parser.add_argument("--device", default=None,
                        help="torch device to solve on (default: cuda)")
    parser.add_argument(
        "--debug-port", type=int, default=None,
        help="serve /healthz, /metrics (admission, device-observatory and "
             "working-set series), /apis/v1/plugins/<name>, /debug/trace, "
             "/debug/device and /debug/profile?rounds=K on this port")
    parser.add_argument(
        "--profile-dir", default=None,
        help="directory of the on-demand torch.profiler windows (default: "
             "$KTPU_PROFILE_DIR or <tmp>/koord-profile)")
    parser.add_argument(
        "--no-warm-pool", action="store_true",
        help="disable the warm pool: a respawned sidecar then issues its "
             "first solve cold again")
    parser.add_argument(
        "--hbm-budget-bytes", type=int, default=0,
        help="device-memory line for the staged tenant bases: staying "
             "under it demotes the least valuable bases to the host or "
             "cold rung instead of allocating past it; 0 = unlimited")
    args = parser.parse_args(argv)

    from koordinator_tpu_torch.service.warmpool import WARM_POOL

    warm_pool = None
    if args.no_warm_pool:
        WARM_POOL.configure("")  # inert: the service must not configure it
    else:
        # the warm pool restores SEQUENTIALLY, right after interpreter
        # start and before the socket opens: a restore racing the first
        # reconnecting client's solve would leave the very request the
        # warm respawn exists for cold. Inert when the store is disabled
        WARM_POOL.configure()
        if WARM_POOL.active:
            warm_pool = WARM_POOL
            WARM_POOL.restore(compile_missing=False)
            WARM_POOL.start_background()

    from koordinator_tpu_torch import resolve_device
    from koordinator_tpu_torch.obs.device import DEVICE_OBS
    from koordinator_tpu_torch.service.server import (
        PlacementService,
        warm_up,
    )
    from koordinator_tpu_torch.state.workingset import WORKING_SET

    if args.hbm_budget_bytes:
        WORKING_SET.set_budget(args.hbm_budget_bytes)
    if args.profile_dir:
        DEVICE_OBS.configure(profile_dir=args.profile_dir)
    secret: Optional[bytes] = None
    if args.secret_file:
        with open(args.secret_file, "rb") as f:
            secret = f.read().strip()
    device = resolve_device(args.device)
    if device.type == "cuda":
        # before the socket is bound: a probe must not find it open
        # while the solve path warms
        from koordinator_tpu_torch.ops import binpack_kernel

        binpack_kernel._library()
        warm_up(device)
    service = PlacementService(parse_address(args.listen), secret=secret,
                               device=device)
    service.start()
    debug_server = None
    try:
        if args.debug_port is not None:
            debug_server = start_debug_server(service, args.debug_port,
                                              warm_pool)
        if args.ready_file:
            with open(args.ready_file, "w") as f:
                f.write(str(os.getpid()))
        debug = ("" if debug_server is None
                 else f", debug port {debug_server.port}")
        print(f"koord-solver: serving on {args.listen} ({service.device})"
              f"{debug}", flush=True)
        if args.once:
            return 0
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        return 0
    finally:
        service.stop()
        if debug_server is not None:
            debug_server.stop()
        if warm_pool is not None:
            warm_pool.stop_background()


if __name__ == "__main__":
    raise SystemExit(main())
