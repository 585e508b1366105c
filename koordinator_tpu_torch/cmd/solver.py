"""koord-solver: the placement-solver sidecar on one device (counterpart
of ``koordinator_tpu/cmd/solver.py``).

    python -m koordinator_tpu_torch.cmd.solver --listen ./solver.sock

The scheduler speaks the framed npz protocol to this process
(``service/client.RemoteSolver``, or the reference's, behind
``--placement-backend=sidecar``), which keeps the kernel library built
and loaded across control-plane restarts. It runs on ``cuda``
(``--device`` names another). The reference's flags whose subsystems
are not ported yet (``--debug-port``, ``--profile-dir``,
``--no-warm-pool``, ``--hbm-budget-bytes``) are refused when given.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional, Tuple, Union

#: the reference's flags whose subsystems this package does not have yet
NOT_PORTED = {
    "debug_port": "--debug-port (the debug mux and metrics)",
    "profile_dir": "--profile-dir (the device observatory)",
    "no_warm_pool": "--no-warm-pool (the AOT warm pool)",
    "hbm_budget_bytes": "--hbm-budget-bytes (the working-set manager)",
}


def parse_address(spec: str) -> Union[str, Tuple[str, int]]:
    """``host:port`` -> TCP tuple; anything else is a UDS path."""
    if ":" in spec and not spec.startswith("/"):
        host, _, port = spec.rpartition(":")
        return (host or "127.0.0.1", int(port))
    return spec


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
    parser.add_argument("--debug-port", type=int, default=None,
                        help="not ported yet: refused")
    parser.add_argument("--profile-dir", default=None,
                        help="not ported yet: refused")
    parser.add_argument("--no-warm-pool", action="store_true",
                        help="not ported yet: refused")
    parser.add_argument("--hbm-budget-bytes", type=int, default=0,
                        help="not ported yet: refused unless 0")
    args = parser.parse_args(argv)
    given = [flag for dest, flag in NOT_PORTED.items()
             if getattr(args, dest) not in (None, False, 0)]
    if given:
        parser.error("not ported yet: " + ", ".join(given))

    from koordinator_tpu_torch.service.server import PlacementService

    secret: Optional[bytes] = None
    if args.secret_file:
        with open(args.secret_file, "rb") as f:
            secret = f.read().strip()
    service = PlacementService(parse_address(args.listen), secret=secret,
                               device=args.device)
    service.start()
    try:
        if args.ready_file:
            with open(args.ready_file, "w") as f:
                f.write(str(os.getpid()))
        print(f"koord-solver: serving on {args.listen} ({service.device})",
              flush=True)
        if args.once:
            return 0
        while True:
            time.sleep(60)
    except KeyboardInterrupt:
        return 0
    finally:
        service.stop()


if __name__ == "__main__":
    raise SystemExit(main())
