"""koord-manager: the manager binary (counterpart of
``koordinator_tpu/cmd/manager.py``).

    python -m koordinator_tpu_torch.cmd.manager --once --cluster-json c.json --device cuda

The reference's cmd/koord-manager/main.go:119-160 registers the
noderesource, nodemetric, nodeslo and quota-profile controllers and the
webhook server, gated by the manager feature gates
(``features.MANAGER_GATES``). :func:`build_manager` wires the same
components; the noderesource controller runs its overcommit step as
torch ops on ``device`` (``cuda`` unless given). :func:`main` seeds a bus
from ``--cluster-json``, reconciles the noderesource loop and the
recommendation controller over it, and returns 0 after one pass with
``--once``, 3 as a standby (``--leader-elect`` with the lease held
elsewhere) and 1 when the lease is lost mid-reconcile.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

from koordinator_tpu_torch import DeviceLike
from koordinator_tpu_torch.features import MANAGER_GATES, FeatureGate


@dataclasses.dataclass
class ManagerConfig:
    feature_gates: str = ""
    #: noderesource sync cadence
    sync_interval_seconds: float = 60.0


@dataclasses.dataclass
class Manager:
    """The wired central controllers (main.go's mgr)."""

    noderesource: object
    nodeslo: object
    mutating_webhook: Optional[object]
    validating_webhook: Optional[object]
    quota_guard: Optional[object]
    profile_controller_factory: object  # scheduler -> QuotaProfileController
    node_mutating_webhook: Optional[object] = None
    node_validating_webhook: Optional[object] = None
    slo_config_webhook: Optional[object] = None

    def admit_pod(self, pod, old_pod=None):
        """The webhook chain every pod passes (mutate, then validate);
        returns (pod, violations)."""
        if self.mutating_webhook is not None:
            pod = self.mutating_webhook.mutate(pod)
        violations = []
        if self.validating_webhook is not None:
            violations = self.validating_webhook.validate(pod, old_pod)
        return pod, violations

    def admit_node(self, node, old_node=None):
        """Node admission (amplification mutate, then validate)."""
        if self.node_mutating_webhook is not None:
            node = self.node_mutating_webhook.mutate(node, old_node)
        violations = []
        if self.node_validating_webhook is not None:
            violations = self.node_validating_webhook.validate(node, old_node)
        return node, violations


def build_manager(config: ManagerConfig,
                  gates: Optional[FeatureGate] = None,
                  device: DeviceLike = None) -> Manager:
    """The manager's components, each webhook behind its gate; the
    noderesource controller on ``device`` (``cuda`` unless given)."""
    from koordinator_tpu_torch.manager.noderesource import (
        NodeResourceController,
    )
    from koordinator_tpu_torch.manager.nodeslo import NodeSLOController
    from koordinator_tpu_torch.quota.profile import QuotaProfileController
    from koordinator_tpu_torch.webhook import (
        NodeMutatingWebhook,
        NodeValidatingWebhook,
        PodMutatingWebhook,
        PodValidatingWebhook,
        QuotaTopologyGuard,
        SLOConfigValidatingWebhook,
    )

    gates = gates or MANAGER_GATES.copy()
    gates.set_from_spec(config.feature_gates)

    def gated(name, cls):
        return cls() if gates.enabled(name) else None

    return Manager(
        noderesource=NodeResourceController(device=device),
        nodeslo=NodeSLOController(),
        mutating_webhook=gated("PodMutatingWebhook", PodMutatingWebhook),
        validating_webhook=gated("PodValidatingWebhook",
                                 PodValidatingWebhook),
        quota_guard=gated("ElasticValidatingWebhook", QuotaTopologyGuard),
        profile_controller_factory=QuotaProfileController,
        node_mutating_webhook=gated("NodeMutatingWebhook",
                                    NodeMutatingWebhook),
        node_validating_webhook=gated("NodeValidatingWebhook",
                                      NodeValidatingWebhook),
        slo_config_webhook=gated("ConfigMapValidatingWebhook",
                                 SLOConfigValidatingWebhook),
    )


def main(argv=None) -> int:
    t_main = time.perf_counter()
    parser = argparse.ArgumentParser("koord-manager")
    parser.add_argument("--feature-gates", default="")
    parser.add_argument("--sync-interval", type=float, default=60.0)
    parser.add_argument("--once", action="store_true")
    parser.add_argument("--cluster-json", default=None)
    parser.add_argument("--leader-elect", action="store_true")
    parser.add_argument("--leader-elect-identity", default=None)
    parser.add_argument(
        "--device", default=None,
        help="torch device of the noderesource step (default: cuda)")
    args = parser.parse_args(argv)
    from koordinator_tpu_torch import resolve_device

    device = resolve_device(args.device)
    config = ManagerConfig(feature_gates=args.feature_gates,
                           sync_interval_seconds=args.sync_interval)
    manager = build_manager(config, device=device)
    enabled = [
        name
        for name, component in (
            ("noderesource", manager.noderesource),
            ("nodeslo", manager.nodeslo),
            ("pod-mutating-webhook", manager.mutating_webhook),
            ("pod-validating-webhook", manager.validating_webhook),
            ("quota-topology-guard", manager.quota_guard),
        )
        if component is not None
    ]
    from koordinator_tpu_torch.client import bus as bus_mod
    from koordinator_tpu_torch.client.leaderelection import FencingError
    from koordinator_tpu_torch.client.wiring import wire_manager
    from koordinator_tpu_torch.manager.recommendation import (
        wire_recommendation,
    )

    bus = bus_mod.APIServer()
    elector = None
    if args.leader_elect:
        import os

        from koordinator_tpu_torch.client.leaderelection import LeaderElector

        elector = LeaderElector(
            bus, "koord-manager",
            args.leader_elect_identity or f"koord-manager-{os.getpid()}",
        )
    loop = wire_manager(bus, manager.noderesource, elector=elector)
    recommender = wire_recommendation(bus, manager.mutating_webhook,
                                      elector=elector)
    t0 = time.perf_counter()
    if args.cluster_json:
        from koordinator_tpu_torch.cmd.scheduler import seed_bus_from_json

        seed_bus_from_json(bus, args.cluster_json)
    seed_s = time.perf_counter() - t0
    print("koord-manager components:", ", ".join(enabled))
    print(f"koord-manager: wired on {device} in "
          f"{time.perf_counter() - t_main:.3f} s (bus seeding "
          f"{seed_s:.3f} s)", flush=True)

    def wait(seconds: float) -> bool:
        """Sleep ``seconds`` while keeping the lease renewed: the sync
        interval (60 s) far exceeds the renew deadline (10 s), so a
        leader ticks at the retry period between reconciles. Returns
        False as soon as leadership is lost."""
        if elector is None:
            time.sleep(seconds)
            return True
        deadline = time.time() + seconds
        while time.time() < deadline:
            time.sleep(min(elector.retry_period,
                           max(deadline - time.time(), 0)))
            if not elector.tick(time.time()):
                return False
        return True

    def once(rc: int) -> int:
        print(f"koord-manager: reconcile returned {rc} after "
              f"{time.perf_counter() - t_pass:.3f} s", flush=True)
        return rc

    while True:
        t_pass = time.perf_counter()
        if elector is not None and not elector.tick(time.time()):
            # standby: keep the recommendation histograms warm so a
            # failover does not start from an empty bank
            recommender.observe(now=time.time())
            print("standby: lease held elsewhere")
            if args.once:
                return once(3)  # distinct from success: no reconcile ran
            time.sleep(elector.retry_period)
            continue
        try:
            synced = loop.reconcile(now=time.time())
            recommender.run_once(now=time.time())
        except FencingError as e:
            # deposed mid-reconcile: demote to standby, do not crash
            print(f"leadership lost mid-reconcile: {e}")
            if args.once:
                return once(1)
        else:
            print(f"noderesource reconcile: {synced} nodes synced")
            if args.once:
                return once(0)
        wait(config.sync_interval_seconds)


if __name__ == "__main__":
    raise SystemExit(main())
