"""The collectors: node/pod/BE/system resource usage + PSI.

Reference: pkg/koordlet/metricsadvisor/collectors/{noderesource,
podresource,beresource,sysresource}/ and util/system/psi.go. Each reads
/proc or cgroupfs (under the configurable roots, so tests use fake
trees), converts cumulative counters to rates between ticks, and appends
canonical-unit samples (mCPU / MiB) to the metric cache.

CPU usage derivation (reference: collectors/noderesource/
node_resource_collector.go): /proc/stat jiffy counters are cumulative;
usage_mcpu = delta(busy_jiffies) / USER_HZ / delta_t * 1000. Pod usage
uses the cgroup's cumulative cpu time (v1 cpuacct.usage ns; v2 cpu.stat
usage_usec).

Counterpart of
``koordinator_tpu/koordlet/metricsadvisor/collectors.py``: host work in
numpy and files, bit for bit the reference's.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

from koordinator_tpu_torch.apis.extension import QoSClass
from koordinator_tpu_torch.koordlet.metriccache import MetricKind
from koordinator_tpu_torch.koordlet.metricsadvisor.framework import (
    CollectorContext,
)
from koordinator_tpu_torch.koordlet.system.cgroup import (
    CPU_ACCT_USAGE,
    MEMORY_USAGE,
    SystemConfig,
)

#: Linux USER_HZ (jiffies per second); constant on every mainstream arch.
USER_HZ = 100


def read_proc_stat_busy_jiffies(cfg: SystemConfig) -> Optional[int]:
    """Sum of non-idle jiffies from the aggregate "cpu " line of
    /proc/stat (user+nice+system+irq+softirq+steal; idle+iowait excluded,
    matching the reference's cpu usage collector)."""
    try:
        with open(os.path.join(cfg.proc_root, "stat")) as f:
            for line in f:
                if line.startswith("cpu "):
                    parts = [int(x) for x in line.split()[1:]]
                    # user nice system idle iowait irq softirq steal ...
                    idle = parts[3] + (parts[4] if len(parts) > 4 else 0)
                    return sum(parts[:8]) - idle
    except (OSError, ValueError, IndexError):
        return None
    return None


def read_meminfo_used_mib(cfg: SystemConfig) -> Optional[float]:
    """MemTotal - MemAvailable in MiB (reference: node memory collector
    uses the same definition)."""
    total = avail = None
    try:
        with open(os.path.join(cfg.proc_root, "meminfo")) as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1])  # kB
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1])
    except (OSError, ValueError, IndexError):
        return None
    if total is None or avail is None:
        return None
    return (total - avail) / 1024.0


def read_cgroup_cpu_ns(cgroup_dir: str, cfg: SystemConfig) -> Optional[int]:
    """Cumulative cpu nanoseconds of a cgroup (v1 cpuacct.usage;
    v2 cpu.stat usage_usec * 1000)."""
    try:
        raw = CPU_ACCT_USAGE.read(cgroup_dir, cfg)
    except OSError:
        return None
    if cfg.use_cgroup_v2:
        for line in raw.splitlines():
            if line.startswith("usage_usec"):
                try:
                    return int(line.split()[1]) * 1000
                except (ValueError, IndexError):
                    return None
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def read_cgroup_memory_mib(cgroup_dir: str, cfg: SystemConfig) -> Optional[float]:
    try:
        return int(MEMORY_USAGE.read(cgroup_dir, cfg)) / (1024.0 * 1024.0)
    except (OSError, ValueError):
        return None


class _RateTracker:
    """Cumulative-counter -> rate conversion between ticks."""

    def __init__(self):
        self._last: Dict[str, Tuple[float, float]] = {}  # key -> (t, value)

    def rate(self, key: str, now: float, value: float) -> Optional[float]:
        last = self._last.get(key)
        self._last[key] = (now, value)
        if last is None:
            return None
        dt = now - last[0]
        if dt <= 0:
            return None
        return max(value - last[1], 0.0) / dt

    def forget_missing(self, live_keys) -> None:
        live = set(live_keys)
        for k in list(self._last):
            if k not in live:
                del self._last[k]


class NodeResourceCollector:
    """Whole-node cpu/memory usage (reference: collectors/noderesource)."""

    name = "noderesource"

    def __init__(self):
        self._rates = _RateTracker()
        self.ctx: Optional[CollectorContext] = None

    def setup(self, ctx: CollectorContext) -> None:
        self.ctx = ctx

    def enabled(self) -> bool:
        return True

    def collect(self, now: float) -> None:
        ctx = self.ctx
        cfg = ctx.system_config
        busy = read_proc_stat_busy_jiffies(cfg)
        if busy is not None:
            jps = self._rates.rate("node_cpu", now, float(busy))
            if jps is not None:
                mcpu = jps / USER_HZ * 1000.0
                ctx.metric_cache.append(
                    MetricKind.NODE_CPU_USAGE, None, now, mcpu
                )
                ctx.latest_node_usage["cpu"] = mcpu
        mem = read_meminfo_used_mib(cfg)
        if mem is not None:
            ctx.metric_cache.append(
                MetricKind.NODE_MEMORY_USAGE, None, now, mem
            )
            ctx.latest_node_usage["memory"] = mem


class PodResourceCollector:
    """Per-pod (and per-container) usage from cgroupfs (reference:
    collectors/podresource)."""

    name = "podresource"

    def __init__(self):
        self._rates = _RateTracker()
        self.ctx: Optional[CollectorContext] = None

    def setup(self, ctx: CollectorContext) -> None:
        self.ctx = ctx

    def enabled(self) -> bool:
        return self.ctx.pod_provider is not None

    def collect(self, now: float) -> None:
        ctx = self.ctx
        cfg = ctx.system_config
        pods = list(ctx.pod_provider.running_pods())
        seen = {}
        for pod in pods:
            usage: Dict[str, float] = {}
            ns = read_cgroup_cpu_ns(pod.cgroup_dir, cfg)
            if ns is not None:
                nsps = self._rates.rate(f"pod:{pod.uid}", now, float(ns))
                if nsps is not None:
                    usage["cpu"] = nsps / 1e9 * 1000.0  # ns/s -> mCPU
                    ctx.metric_cache.append(
                        MetricKind.POD_CPU_USAGE, {"pod": pod.uid}, now,
                        usage["cpu"],
                    )
            mem = read_cgroup_memory_mib(pod.cgroup_dir, cfg)
            if mem is not None:
                usage["memory"] = mem
                ctx.metric_cache.append(
                    MetricKind.POD_MEMORY_USAGE, {"pod": pod.uid}, now, mem
                )
            for cname, cdir in pod.containers.items():
                cns = read_cgroup_cpu_ns(cdir, cfg)
                if cns is not None:
                    rate = self._rates.rate(
                        f"container:{pod.uid}/{cname}", now, float(cns)
                    )
                    if rate is not None:
                        ctx.metric_cache.append(
                            MetricKind.CONTAINER_CPU_USAGE,
                            {"pod": pod.uid, "container": cname},
                            now, rate / 1e9 * 1000.0,
                        )
            seen[pod.uid] = usage
        ctx.latest_pod_usage.clear()
        ctx.latest_pod_usage.update(seen)
        self._rates.forget_missing(
            [f"pod:{p.uid}" for p in pods]
            + [f"container:{p.uid}/{c}" for p in pods for c in p.containers]
        )


class BEResourceCollector:
    """Aggregate best-effort usage (reference: collectors/beresource):
    sum of BE pods' usage, for the cpusuppress strategy."""

    name = "beresource"

    def __init__(self):
        self.ctx: Optional[CollectorContext] = None

    def setup(self, ctx: CollectorContext) -> None:
        self.ctx = ctx

    def enabled(self) -> bool:
        return self.ctx.pod_provider is not None

    def collect(self, now: float) -> None:
        ctx = self.ctx
        be_cpu = 0.0
        have_rate = False
        for pod in ctx.pod_provider.running_pods():
            if pod.qos is not QoSClass.BE:
                continue
            usage = ctx.latest_pod_usage.get(pod.uid, {})
            # primer ticks have no cpu rate yet: no data is no sample,
            # not a zero that skews the suppress/evict aggregates
            if "cpu" in usage:
                have_rate = True
                be_cpu += usage["cpu"]
        if have_rate:
            ctx.metric_cache.append(
                MetricKind.BE_CPU_USAGE, None, now, be_cpu
            )


class SysResourceCollector:
    """System usage = node usage - Σ pod usage, clamped at zero
    (reference: collectors/sysresource — feeds the batch overcommit
    calculator's System.Used term)."""

    name = "sysresource"

    def __init__(self):
        self.ctx: Optional[CollectorContext] = None

    def setup(self, ctx: CollectorContext) -> None:
        self.ctx = ctx

    def enabled(self) -> bool:
        return True

    def collect(self, now: float) -> None:
        ctx = self.ctx
        node = ctx.latest_node_usage
        if not node:
            return
        pods_cpu = sum(u.get("cpu", 0.0) for u in ctx.latest_pod_usage.values())
        pods_mem = sum(
            u.get("memory", 0.0) for u in ctx.latest_pod_usage.values()
        )
        if "cpu" in node:
            ctx.metric_cache.append(
                MetricKind.SYS_CPU_USAGE, None, now,
                max(node["cpu"] - pods_cpu, 0.0),
            )
        if "memory" in node:
            ctx.metric_cache.append(
                MetricKind.SYS_MEMORY_USAGE, None, now,
                max(node["memory"] - pods_mem, 0.0),
            )


def read_psi_avg10(path: str, want_full: bool = False) -> Optional[float]:
    """Parse "some avg10=X ..." / "full avg10=X ..." from a PSI file
    (reference: util/system/psi.go)."""
    try:
        with open(path) as f:
            for line in f:
                kind, _, rest = line.partition(" ")
                if (kind == "full") == want_full:
                    for field in rest.split():
                        if field.startswith("avg10="):
                            return float(field[len("avg10="):])
    except (OSError, ValueError):
        return None
    return None


class PSICollector:
    """Node pressure-stall information from /proc/pressure (reference:
    PSICollector feature gate + collectors wiring psi into metriccache)."""

    name = "psi"

    _SOURCES = (
        ("cpu", False, MetricKind.PSI_CPU_SOME_AVG10),
        ("memory", False, MetricKind.PSI_MEM_SOME_AVG10),
        ("memory", True, MetricKind.PSI_MEM_FULL_AVG10),
        ("io", False, MetricKind.PSI_IO_SOME_AVG10),
    )

    def __init__(self):
        self.ctx: Optional[CollectorContext] = None

    def setup(self, ctx: CollectorContext) -> None:
        self.ctx = ctx

    def enabled(self) -> bool:
        return os.path.isdir(
            os.path.join(self.ctx.system_config.proc_root, "pressure")
        )

    def collect(self, now: float) -> None:
        ctx = self.ctx
        base = os.path.join(ctx.system_config.proc_root, "pressure")
        for res, full, kind in self._SOURCES:
            v = read_psi_avg10(os.path.join(base, res), full)
            if v is not None:
                ctx.metric_cache.append(kind, None, now, v)


def default_collectors():
    """The standard collector set (reference: metrics_advisor.go
    collector registry). Device/throttled/storage collectors self-gate
    via enabled() on their source trees."""
    from koordinator_tpu_torch.koordlet.metricsadvisor.devices import (
        DeviceCollector,
        NodeStorageInfoCollector,
        PodThrottledCollector,
    )

    return [
        NodeResourceCollector(),
        PodResourceCollector(),
        BEResourceCollector(),
        SysResourceCollector(),
        PSICollector(),
        DeviceCollector(),
        PodThrottledCollector(),
        NodeStorageInfoCollector(),
    ]


class ColdMemoryCollector:
    """kidled cold-page collector (reference: metricsadvisor/collectors/
    coldmemoryresource, ColdPageCollector feature gate): reads the root
    cgroup's memory.idle_page_stats and appends the reclaimable cold-page
    bytes."""

    name = "coldmemory"

    def __init__(self, cold_boundary: Optional[int] = None):
        from koordinator_tpu_torch.koordlet.system.kidled import (
            DEFAULT_COLD_BOUNDARY,
        )

        self.ctx: Optional[CollectorContext] = None
        self.cold_boundary = (
            cold_boundary if cold_boundary is not None else DEFAULT_COLD_BOUNDARY
        )
        self._kidled = None

    #: default scan cadence written at setup when kidled is idle
    #: (reference: kidled_util.go defaultKidledScanPeriodInSeconds)
    DEFAULT_SCAN_PERIOD_SECONDS = 120

    def setup(self, ctx: CollectorContext) -> None:
        from koordinator_tpu_torch.koordlet.system.kidled import Kidled

        self.ctx = ctx
        self._kidled = Kidled(ctx.system_config)
        if self._kidled.supported():
            # the kernel default scan period is 0 (scanning off): start
            # scanning or idle_page_stats never accumulates (the
            # reference collector configures kidled at startup)
            try:
                self._kidled.set_scan_period(self.DEFAULT_SCAN_PERIOD_SECONDS)
                self._kidled.set_use_hierarchy(True)
            except OSError:
                self._kidled = None

    def enabled(self) -> bool:
        return self._kidled is not None and self._kidled.supported()

    def collect(self, now: float) -> None:
        stats = self._kidled.read_stats("")
        if stats is None:
            return
        self.ctx.metric_cache.append(
            MetricKind.NODE_COLD_PAGE_BYTES, None, now,
            float(stats.cold_page_bytes(self.cold_boundary)),
        )


class PageCacheCollector:
    """Node page-cache collector (reference: collectors/pagecache): the
    meminfo Cached amount, feeding cache-aware overcommit policies."""

    name = "pagecache"

    def __init__(self):
        self.ctx: Optional[CollectorContext] = None

    def setup(self, ctx: CollectorContext) -> None:
        self.ctx = ctx

    def enabled(self) -> bool:
        return os.path.exists(
            os.path.join(self.ctx.system_config.proc_root, "meminfo")
        )

    def collect(self, now: float) -> None:
        path = os.path.join(self.ctx.system_config.proc_root, "meminfo")
        try:
            with open(path) as f:
                for line in f:
                    if line.startswith("Cached:"):
                        kb = int(line.split()[1])
                        self.ctx.metric_cache.append(
                            MetricKind.NODE_PAGE_CACHE_MIB, None, now,
                            kb / 1024.0,
                        )
                        return
        except (OSError, ValueError, IndexError):
            return


class HostApplicationCollector:
    """Host-application usage collector (reference: collectors/
    hostapplication): per NodeSLO host app, read its cgroup cpu/memory
    and append HOST_APP_* samples with the app label. The informer's
    NodeSLO carries the app list (statesinformer.get_node_slo)."""

    name = "hostapplication"

    def __init__(self, slo_provider=None):
        #: callable returning the current NodeSLOSpec (the informer)
        self.slo_provider = slo_provider
        self.ctx: Optional[CollectorContext] = None
        self._rates = _RateTracker()

    def setup(self, ctx: CollectorContext) -> None:
        self.ctx = ctx

    def enabled(self) -> bool:
        return self.slo_provider is not None

    def collect(self, now: float) -> None:
        ctx = self.ctx
        cfg = ctx.system_config
        slo = self.slo_provider()
        raw = getattr(slo, "host_applications", None) or []
        # duplicate names would interleave unrelated cumulative counters
        # through one rate-tracker key (garbage rates) — first wins
        apps = list({app.name: app for app in reversed(raw)}.values())[::-1]
        for app in apps:
            if not app.cgroup_dir:
                continue
            ns = read_cgroup_cpu_ns(app.cgroup_dir, cfg)
            if ns is not None:
                rate = self._rates.rate(f"hostapp:{app.name}", now, float(ns))
                if rate is not None:
                    ctx.metric_cache.append(
                        MetricKind.HOST_APP_CPU_USAGE, {"app": app.name},
                        now, rate / 1e9 * 1000.0,
                    )
            mem = read_cgroup_memory_mib(app.cgroup_dir, cfg)
            if mem is not None:
                ctx.metric_cache.append(
                    MetricKind.HOST_APP_MEMORY_USAGE, {"app": app.name},
                    now, mem,
                )
        self._rates.forget_missing([f"hostapp:{a.name}" for a in apps])
