"""koord-descheduler: the descheduler binary (counterpart of
``koordinator_tpu/cmd/descheduler.py``).

    python -m koordinator_tpu_torch.cmd.descheduler --once --cluster-json c.json

Profiles of Deschedule and Balance plugins run on the descheduling
interval (upstream's pkg/descheduler/descheduler.go); the LowNodeLoad
balance plugin and the migration-evictor mode are the component
config's knobs. :func:`main` wires a
:class:`~koordinator_tpu_torch.client.wiring.DeschedulerLoop` over a bus:
each migration reserves its destination through the placement solver on
``--device`` (``cuda`` unless given), then evicts through the bus.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

from koordinator_tpu_torch.features import FeatureGate

#: the descheduler's gates (the reference reuses the scheduler registry;
#: the toggles that matter here are the eviction mode and the anomaly
#: debounce)
DESCHEDULER_GATES = FeatureGate({
    "MigrationController": True,
    "AnomalyDetection": True,
})


@dataclasses.dataclass
class DeschedulerConfig:
    feature_gates: str = ""
    descheduling_interval_seconds: float = 120.0
    #: LowNodeLoad thresholds (percent)
    low_cpu_percent: int = 45
    high_cpu_percent: int = 65
    #: consecutive abnormal observations before an eviction
    anomaly_condition_count: int = 3
    max_migrating_per_node: int = 2


def build_descheduler(config: DeschedulerConfig,
                      gates: Optional[FeatureGate] = None):
    """A Descheduler with one profile: LowNodeLoad over one node pool at
    the config's CPU thresholds, its anomaly debounce (1 with
    ``AnomalyDetection`` off), behind a per-node eviction limit, through
    the migration evictor (the direct one with ``MigrationController``
    off)."""
    from koordinator_tpu_torch.apis.extension import ResourceName
    from koordinator_tpu_torch.descheduler.framework import (
        Descheduler,
        DirectEvictor,
        EvictionLimiter,
        MigrationEvictor,
        Profile,
    )
    from koordinator_tpu_torch.descheduler.loadaware import (
        LowNodeLoad,
        LowNodeLoadArgs,
        NodePool,
    )

    gates = gates or DESCHEDULER_GATES.copy()
    gates.set_from_spec(config.feature_gates)
    pool = NodePool(
        low_thresholds={ResourceName.CPU: config.low_cpu_percent},
        high_thresholds={ResourceName.CPU: config.high_cpu_percent},
        consecutive_abnormalities=(
            config.anomaly_condition_count
            if gates.enabled("AnomalyDetection")
            else 1
        ),
    )
    plugin = LowNodeLoad(LowNodeLoadArgs(node_pools=[pool]))
    limiter = EvictionLimiter(max_per_node=config.max_migrating_per_node)
    evictor = (
        MigrationEvictor(limiter)
        if gates.enabled("MigrationController")
        else DirectEvictor(limiter)
    )
    return Descheduler(
        profiles=[Profile(name="default", balance_plugins=[plugin])],
        evictor=evictor,
        descheduling_interval=config.descheduling_interval_seconds,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("koord-descheduler")
    parser.add_argument("--feature-gates", default="")
    parser.add_argument("--descheduling-interval", type=float, default=120.0)
    parser.add_argument("--once", action="store_true")
    parser.add_argument("--cluster-json", default=None)
    parser.add_argument("--leader-elect", action="store_true")
    parser.add_argument("--leader-elect-identity", default=None)
    parser.add_argument(
        "--device", default=None,
        help="torch device of the migrations' placement probes (default: "
             "cuda)")
    args = parser.parse_args(argv)
    descheduler = build_descheduler(DeschedulerConfig(
        feature_gates=args.feature_gates,
        descheduling_interval_seconds=args.descheduling_interval))
    from koordinator_tpu_torch.client import bus as bus_mod
    from koordinator_tpu_torch.client.leaderelection import FencingError
    from koordinator_tpu_torch.client.wiring import wire_descheduler
    from koordinator_tpu_torch.cmd.scheduler import seed_bus_from_json

    bus = bus_mod.APIServer()
    elector = None
    if args.leader_elect:
        import os

        from koordinator_tpu_torch.client.leaderelection import LeaderElector

        elector = LeaderElector(
            bus, "koord-descheduler",
            args.leader_elect_identity or f"koord-descheduler-{os.getpid()}")
    loop = wire_descheduler(bus, descheduler, elector=elector,
                            device=args.device)
    if args.cluster_json:
        seed_bus_from_json(bus, args.cluster_json)
    print("koord-descheduler: profiles="
          f"{[p.name for p in descheduler.profiles]}, "
          f"interval={descheduler.descheduling_interval}s")

    def wait(seconds: float) -> None:
        """Sleep while renewing: the descheduling interval (120 s) far
        exceeds the lease's renew deadline (10 s)."""
        if elector is None:
            time.sleep(seconds)
            return
        deadline = time.time() + seconds
        while time.time() < deadline:
            time.sleep(min(elector.retry_period,
                           max(deadline - time.time(), 0)))
            if not elector.tick(time.time()):
                return

    while True:
        if elector is not None and not elector.tick(time.time()):
            print("standby: lease held elsewhere")
            if args.once:
                return 3
            time.sleep(elector.retry_period)
            continue
        try:
            migrated = loop.run_once(now=time.time())
        except FencingError as e:
            print(f"leadership lost mid-cycle: {e}")
            if args.once:
                return 1
        else:
            print(f"descheduling cycle: migrated {len(migrated)} pods")
            if args.once:
                return 0
        wait(descheduler.descheduling_interval)


if __name__ == "__main__":
    raise SystemExit(main())
