"""koordlet entry point: the node agent daemon assembly.

Reference: cmd/koordlet/main.go + pkg/koordlet/koordlet.go:70-126
(NewDaemon wiring: executor → metriccache → statesinformer →
metricsadvisor → predictServer → qosManager → runtimeHooks) with the
koordlet feature gates (pkg/features/koordlet_features.go) toggling each
collector/strategy.

Counterpart of ``koordinator_tpu/cmd/koordlet.py``: the same assembly,
gates and flags, plus ``--now``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

from koordinator_tpu_torch.features import KOORDLET_GATES, FeatureGate


@dataclasses.dataclass
class KoordletConfig:
    feature_gates: str = ""
    cgroup_root: str = "/sys/fs/cgroup"
    proc_root: str = "/proc"
    use_cgroup_v2: bool = False
    collect_interval_seconds: float = 1.0
    reconcile_interval_seconds: float = 10.0
    node_capacity_mcpu: int = 0
    node_capacity_mem_mib: int = 0
    #: runtimehooks actuation mode (reference --runtime-hooks-mode):
    #: ``reconciler`` heals periodically off informer state; ``nri``
    #: additionally dispatches hook stages from the PLEG event stream
    runtime_hooks_mode: str = "reconciler"
    #: local checkpoint dir (reference §5.4: prediction histograms +
    #: TSDB survive restarts); empty = no persistence
    checkpoint_dir: str = ""
    checkpoint_interval_seconds: float = 60.0
    #: PV name -> block device "MAJ:MIN" (the host's volume-attachment
    #: view; the reference walks /var/lib/kubelet + sysfs — here the CSI
    #: layer/operator supplies the map). Feeds blkio pod-volume throttles.
    volume_devices: Optional[dict] = None


@dataclasses.dataclass
class KoordletDaemon:
    """The wired node agent (koordlet.go Daemon)."""

    states_informer: object
    metric_cache: object
    metrics_advisor: object
    qos_manager: object
    predict_server: object
    auditor: object
    executor: object
    collector_ctx: object = None
    runtime_hooks: object = None
    pleg: object = None
    nri_server: object = None
    reconcile_interval_seconds: float = 10.0
    checkpoint_dir: str = ""
    checkpoint_interval_seconds: float = 60.0
    _last_reconcile: float = 0.0
    _last_checkpoint: float = 0.0

    def tick(self, now: Optional[float] = None) -> None:
        """One daemon step: collect → predict → actuate → hooks (the
        run order of koordlet.go:127-188)."""
        now = time.time() if now is None else now
        self.metrics_advisor.tick(now)
        self._feed_predictor(now)
        self.qos_manager.tick(now)
        if self.pleg is not None:
            # NRI mode: lifecycle events dispatch hook stages directly
            self.pleg.poll()
        if self.runtime_hooks is not None and (
            now - self._last_reconcile >= self.reconcile_interval_seconds
        ):
            self._last_reconcile = now
            self.runtime_hooks.reconcile()
        if self.checkpoint_dir and (
            now - self._last_checkpoint >= self.checkpoint_interval_seconds
        ):
            self._last_checkpoint = now
            self.checkpoint()

    def checkpoint(self) -> None:
        """Persist restart state (§5.4): the metric TSDB + the
        prediction histograms."""
        import os

        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.metric_cache.save(
            os.path.join(self.checkpoint_dir, "metriccache.npz")
        )
        self.predict_server.save_checkpoint(
            os.path.join(self.checkpoint_dir, "prediction.json")
        )

    def _feed_predictor(self, now: float) -> None:
        """Stream the latest usage samples into the peak predictor
        (predict_server.go's informer subscription)."""
        ctx = self.collector_ctx
        if ctx is None:
            return
        from koordinator_tpu_torch.koordlet.prediction.predict_server import (
            NODE_KEY,
            pod_key,
        )

        node_usage = ctx.latest_node_usage
        if node_usage:
            self.predict_server.update(
                NODE_KEY,
                node_usage.get("cpu", 0.0),
                node_usage.get("memory", 0.0),
                now,
            )
        live_keys = []
        for uid, usage in ctx.latest_pod_usage.items():
            key = pod_key(uid)
            live_keys.append(key)
            self.predict_server.update(
                key,
                usage.get("cpu", 0.0),
                usage.get("memory", 0.0),
                now,
            )
        # forget churned pods so predictor state stays bounded
        self.predict_server.gc(live_keys)


def _be_allocatable(states_informer) -> Optional[int]:
    """BE tier allocatable (node batch-cpu) from the informer's node
    view — the cpu-evict evictByAllocatable denominator."""
    from koordinator_tpu_torch.apis.extension import ResourceName

    node = states_informer.get_node()
    if node is None:
        return None
    value = node.allocatable.get(ResourceName.BATCH_CPU)
    return int(value) if value else None


def build_koordlet(
    config: KoordletConfig, gates: Optional[FeatureGate] = None
) -> KoordletDaemon:
    """NewDaemon (koordlet.go:70): every subsystem built, gates deciding
    which collectors/strategies register."""
    from koordinator_tpu_torch.koordlet.audit import Auditor
    from koordinator_tpu_torch.koordlet.metriccache import MetricCache
    from koordinator_tpu_torch.koordlet.metricsadvisor.collectors import (
        BEResourceCollector,
        ColdMemoryCollector,
        HostApplicationCollector,
        NodeResourceCollector,
        PageCacheCollector,
        PodResourceCollector,
        PSICollector,
        SysResourceCollector,
    )
    from koordinator_tpu_torch.koordlet.metricsadvisor.framework import (
        CollectorContext,
        MetricsAdvisor,
    )
    from koordinator_tpu_torch.koordlet.metricsadvisor.performance import (
        PerformanceCollector,
    )
    from koordinator_tpu_torch.koordlet.prediction import (
        PeakPredictServer,
        PredictionConfig,
    )
    from koordinator_tpu_torch.koordlet.qosmanager import (
        BlkIOReconcile,
        CgroupResourcesReconcile,
        CPUBurst,
        CPUEvictor,
        CPUSuppress,
        MemoryEvictor,
        QoSContext,
        QoSManager,
        ResctrlReconcile,
        SystemConfigReconcile,
    )
    from koordinator_tpu_torch.koordlet.resourceexecutor import (
        ResourceUpdateExecutor,
    )
    from koordinator_tpu_torch.koordlet.statesinformer import StatesInformer
    from koordinator_tpu_torch.koordlet.system.cgroup import SystemConfig

    gates = gates or KOORDLET_GATES.copy()
    gates.set_from_spec(config.feature_gates)

    system_config = SystemConfig(
        cgroup_root=config.cgroup_root,
        proc_root=config.proc_root,
        use_cgroup_v2=config.use_cgroup_v2,
    )
    auditor = Auditor() if gates.enabled("AuditEvents") else None
    executor = ResourceUpdateExecutor(system_config, auditor=auditor)
    metric_cache = MetricCache()
    # the informer IS the PodProvider (running_pods) for every subsystem
    states_informer = StatesInformer()
    pod_provider = states_informer
    collector_ctx = CollectorContext(
        metric_cache=metric_cache,
        system_config=system_config,
        pod_provider=pod_provider,
    )
    collectors: List[object] = [
        NodeResourceCollector(),
        PodResourceCollector(),
        BEResourceCollector(),
        SysResourceCollector(),
        HostApplicationCollector(slo_provider=states_informer.get_node_slo),
    ]
    if gates.enabled("PSICollector"):
        collectors.append(PSICollector())
    if gates.enabled("CPICollector"):
        collectors.append(PerformanceCollector())
    if gates.enabled("ColdPageCollector"):
        collectors.append(ColdMemoryCollector())
        collectors.append(PageCacheCollector())
    from koordinator_tpu_torch.koordlet.metricsadvisor.devices import (
        DeviceCollector,
        NodeStorageInfoCollector,
        PodThrottledCollector,
    )

    collectors.append(PodThrottledCollector())
    collectors.append(NodeStorageInfoCollector())
    if gates.enabled("Accelerators"):
        collectors.append(DeviceCollector())
    metrics_advisor = MetricsAdvisor(
        collector_ctx, collectors,
        interval_seconds=config.collect_interval_seconds,
    )

    predict_server = PeakPredictServer(PredictionConfig())

    qos_ctx = QoSContext(
        metric_cache=metric_cache,
        executor=executor,
        pod_provider=pod_provider,
        system_config=system_config,
        auditor=auditor,
        node_capacity_mcpu=config.node_capacity_mcpu,
        node_capacity_mem_mib=config.node_capacity_mem_mib,
        # PVC claim -> bound PV -> device for blkio pod-volume throttles
        volume_name_fn=states_informer.get_volume_name,
        volume_devices=dict(config.volume_devices or {}),
        be_allocatable_fn=lambda: _be_allocatable(states_informer),
    )
    strategies: List[object] = []
    if gates.enabled("BECPUSuppress"):
        strategies.append(CPUSuppress())
    if gates.enabled("BECPUEvict"):
        strategies.append(CPUEvictor())
    if gates.enabled("BEMemoryEvict"):
        strategies.append(MemoryEvictor())
    if gates.enabled("CPUBurst"):
        strategies.append(CPUBurst())
    if gates.enabled("RdtResctrl"):
        strategies.append(ResctrlReconcile())
    if gates.enabled("CgroupReconcile"):
        strategies.append(CgroupResourcesReconcile())
    if gates.enabled("BlkIOReconcile"):
        strategies.append(BlkIOReconcile())
    if gates.enabled("SystemConfig"):
        strategies.append(SystemConfigReconcile())
    for strategy in strategies:
        if strategy.name in ("resctrl", "cgreconcile", "blkio", "sysreconcile"):
            strategy.interval_seconds = config.reconcile_interval_seconds
    qos_manager = QoSManager(qos_ctx, strategies)

    # NodeSLO changes flow from the informer into the QoS strategies
    from koordinator_tpu_torch.koordlet.statesinformer.states_informer import (
        StateKind,
    )

    states_informer.register_callback(
        StateKind.NODE_SLO,
        lambda kind, slo: setattr(qos_ctx, "node_slo", slo),
    )
    # the cpu-normalization ratio (node annotation) feeds quota-burst
    # bases so burst scaling floors at the normalized quota
    from koordinator_tpu_torch.koordlet.runtimehooks.cpunormalization import (
        parse_ratio_from_annotations,
    )

    states_informer.register_callback(
        StateKind.NODE,
        lambda kind, node: setattr(
            qos_ctx, "cpu_normalization_ratio",
            parse_ratio_from_annotations(getattr(node, "annotations", None)),
        ),
    )

    # runtimehooks: bvt/cpuset/batchresource actuation (koordlet.go runs
    # runtimeHooks last); reconciler mode is always armed, NRI mode
    # additionally streams PLEG lifecycle events into the hook server
    from koordinator_tpu_torch.koordlet.pleg import PLEG
    from koordinator_tpu_torch.koordlet.runtimehooks import RuntimeHooks

    runtime_hooks = RuntimeHooks(states_informer, executor)
    pleg = nri_server = None
    if config.runtime_hooks_mode == "nri":
        pleg = PLEG(system_config)
        nri_server = runtime_hooks.attach_nri(pleg)
        pleg.poll()  # primer
    elif config.runtime_hooks_mode != "reconciler":
        raise ValueError(
            f"unknown runtime hooks mode: {config.runtime_hooks_mode!r}"
        )

    if config.checkpoint_dir:
        # resume from the previous incarnation's state (§5.4)
        import os

        metric_cache.load(
            os.path.join(config.checkpoint_dir, "metriccache.npz")
        )
        predict_server.load_checkpoint(
            os.path.join(config.checkpoint_dir, "prediction.json")
        )

    return KoordletDaemon(
        states_informer=states_informer,
        metric_cache=metric_cache,
        metrics_advisor=metrics_advisor,
        qos_manager=qos_manager,
        predict_server=predict_server,
        auditor=auditor,
        executor=executor,
        collector_ctx=collector_ctx,
        runtime_hooks=runtime_hooks,
        pleg=pleg,
        nri_server=nri_server,
        reconcile_interval_seconds=config.reconcile_interval_seconds,
        checkpoint_dir=config.checkpoint_dir,
        checkpoint_interval_seconds=config.checkpoint_interval_seconds,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("koordlet")
    parser.add_argument("--feature-gates", default="")
    parser.add_argument("--cgroup-root", default="/sys/fs/cgroup")
    parser.add_argument("--proc-root", default="/proc")
    parser.add_argument("--cgroup-v2", action="store_true")
    parser.add_argument("--collect-interval", type=float, default=1.0)
    parser.add_argument("--runtime-hooks-mode",
                        choices=("reconciler", "nri"), default="reconciler")
    parser.add_argument("--checkpoint-dir", default="",
                        help="persist TSDB + prediction state across "
                             "restarts (empty = off)")
    parser.add_argument("--debug-port", type=int, default=None,
                        help="serve /healthz /metrics /audit on this port")
    parser.add_argument("--once", action="store_true")
    parser.add_argument("--now", type=float, default=None,
                        help="the clock of the --once tick in seconds "
                             "(default: the wall clock)")
    args = parser.parse_args(argv)
    if args.now is not None and not args.once:
        parser.error("--now needs --once")
    t_main = time.perf_counter()
    daemon = build_koordlet(
        KoordletConfig(
            feature_gates=args.feature_gates,
            cgroup_root=args.cgroup_root,
            proc_root=args.proc_root,
            use_cgroup_v2=args.cgroup_v2,
            collect_interval_seconds=args.collect_interval,
            runtime_hooks_mode=args.runtime_hooks_mode,
            checkpoint_dir=args.checkpoint_dir,
        )
    )
    print(f"koordlet: built ({args.runtime_hooks_mode} mode) in "
          f"{time.perf_counter() - t_main:.3f} s", flush=True)
    http_server = None
    if args.debug_port is not None:
        from koordinator_tpu_torch.metrics.components import (
            KOORDLET_EXTERNAL_METRICS,
            KOORDLET_INTERNAL_METRICS,
        )
        from koordinator_tpu_torch.metrics.registry import MergedGatherer
        from koordinator_tpu_torch.utils.debug_http import DebugHTTPServer

        # internal + external sets on one endpoint (merged_gather.go)
        http_server = DebugHTTPServer(
            metrics=MergedGatherer([KOORDLET_INTERNAL_METRICS,
                                    KOORDLET_EXTERNAL_METRICS]),
            auditor=daemon.auditor,
            port=args.debug_port,
        ).start()
        print(f"debug http on 127.0.0.1:{http_server.port}")
    try:
        while True:
            t_tick = time.perf_counter()
            daemon.tick(args.now)
            if args.once:
                print(f"koordlet: tick returned after "
                      f"{time.perf_counter() - t_tick:.3f} s", flush=True)
                return 0
            time.sleep(args.collect_interval)
    finally:
        if http_server is not None:
            http_server.stop()


if __name__ == "__main__":
    raise SystemExit(main())
