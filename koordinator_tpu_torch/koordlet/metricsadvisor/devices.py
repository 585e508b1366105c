"""Device telemetry + podthrottled + nodestorageinfo collectors.

Reference: pkg/koordlet/metricsadvisor/devices/gpu/collector_gpu_linux.go
(NVML inventory/health/utilization feeding the Device CR), and
collectors/{podthrottled,nodestorageinfo}. This collector reads a
sysfs-style accelerator tree instead of binding NVML:

    <sysfs_root>/class/accel/accel<N>/
        device_type    ("tpu" | "gpu" | ...)
        healthy        ("1" | "0")
        mem_total_mib  (int)
        mem_used_mib   (int)
        utilization    (percent int)
        numa_node, socket_id, pcie_id

Tests point ``SystemConfig.sysfs_root`` at a fake tree (the same pattern
as the cgroupfs fakes). The collector is both a metricsadvisor plugin
(utilization/memory samples into the TSDB) and a
``statesinformer.DeviceSource`` (inventory for the DeviceReporter →
Device objects on the bus → DeviceShare).

Counterpart of ``koordinator_tpu/koordlet/metricsadvisor/devices.py``:
host work in numpy and files, bit for bit the reference's.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from koordinator_tpu_torch.device.cache import (
    DeviceEntry,
    DeviceResourceName,
    DeviceType,
)
from koordinator_tpu_torch.koordlet.metriccache import MetricKind
from koordinator_tpu_torch.koordlet.metricsadvisor.collectors import (
    _RateTracker,
)
from koordinator_tpu_torch.koordlet.metricsadvisor.framework import (
    CollectorContext,
)
from koordinator_tpu_torch.koordlet.system.cgroup import CPU_STAT, SystemConfig


def _read(path: str) -> Optional[str]:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return None


def _read_int(path: str) -> Optional[int]:
    raw = _read(path)
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


class DeviceCollector:
    """Accelerator inventory + telemetry from the sysfs accel tree."""

    name = "device"

    def __init__(self, cfg: Optional[SystemConfig] = None):
        self.ctx: Optional[CollectorContext] = None
        self._cfg = cfg

    def setup(self, ctx: CollectorContext) -> None:
        self.ctx = ctx
        if self._cfg is None:
            self._cfg = ctx.system_config

    def _accel_root(self) -> str:
        return os.path.join(self._cfg.sysfs_root, "class", "accel")

    def enabled(self) -> bool:
        return os.path.isdir(self._accel_root())

    def _minors(self) -> List[int]:
        try:
            names = os.listdir(self._accel_root())
        except OSError:
            return []
        minors = []
        for name in names:
            if name.startswith("accel"):
                try:
                    minors.append(int(name[len("accel"):]))
                except ValueError:
                    continue
        return sorted(minors)

    # -- statesinformer.DeviceSource -----------------------------------------

    def list_devices(self) -> List[DeviceEntry]:
        """Typed inventory for the Device reporting path (the NVML
        device-info read, collector_gpu_linux.go)."""
        entries = []
        for minor in self._minors():
            d = os.path.join(self._accel_root(), f"accel{minor}")
            mem_total = _read_int(os.path.join(d, "mem_total_mib")) or 0
            dtype = _read(os.path.join(d, "device_type")) or "gpu"
            entries.append(DeviceEntry(
                minor=minor,
                device_type=(
                    DeviceType(dtype)
                    if dtype in DeviceType._value2member_map_
                    else DeviceType.GPU
                ),
                resources={
                    DeviceResourceName.GPU_CORE: 100,
                    DeviceResourceName.GPU_MEMORY: mem_total,
                    DeviceResourceName.GPU_MEMORY_RATIO: 100,
                },
                socket_id=_read_int(os.path.join(d, "socket_id")) or 0,
                numa_node=_read_int(os.path.join(d, "numa_node")) or 0,
                pcie_id=_read(os.path.join(d, "pcie_id")) or "0",
                labels={"type": dtype},
                health=(_read(os.path.join(d, "healthy")) != "0"),
            ))
        return entries

    # -- metricsadvisor.Collector --------------------------------------------

    def collect(self, now: float) -> None:
        cache = self.ctx.metric_cache
        for minor in self._minors():
            d = os.path.join(self._accel_root(), f"accel{minor}")
            util = _read_int(os.path.join(d, "utilization"))
            if util is not None:
                cache.append(
                    MetricKind.DEVICE_UTIL, {"minor": str(minor)}, now,
                    float(util),
                )
            used = _read_int(os.path.join(d, "mem_used_mib"))
            if used is not None:
                cache.append(
                    MetricKind.DEVICE_MEMORY_USED, {"minor": str(minor)},
                    now, float(used),
                )


def read_cgroup_cpu_stat(cgroup_dir: str,
                         cfg: SystemConfig) -> Optional[Dict[str, int]]:
    """Parse cpu.stat's nr_periods/nr_throttled/throttled_time
    (v1 cpu/cpu.stat; v2 cpu.stat carries the same keys plus usage)."""
    try:
        raw = CPU_STAT.read(cgroup_dir, cfg)
    except OSError:
        return None
    out: Dict[str, int] = {}
    for line in raw.splitlines():
        parts = line.split()
        if len(parts) == 2:
            try:
                out[parts[0]] = int(parts[1])
            except ValueError:
                continue
    if "nr_periods" not in out:
        return None
    return out


class PodThrottledCollector:
    """Per-pod cfs throttling ratio (reference: collectors/podthrottled):
    Δnr_throttled / Δnr_periods between ticks."""

    name = "podthrottled"

    def __init__(self):
        self._periods = _RateTracker()
        self._throttled = _RateTracker()
        self.ctx: Optional[CollectorContext] = None

    def setup(self, ctx: CollectorContext) -> None:
        self.ctx = ctx

    def enabled(self) -> bool:
        return self.ctx.pod_provider is not None

    def collect(self, now: float) -> None:
        ctx = self.ctx
        cfg = ctx.system_config
        pods = list(ctx.pod_provider.running_pods())
        for pod in pods:
            stat = read_cgroup_cpu_stat(pod.cgroup_dir, cfg)
            if stat is None:
                continue
            dp = self._periods.rate(
                f"pod:{pod.uid}", now, float(stat["nr_periods"])
            )
            dt = self._throttled.rate(
                f"pod:{pod.uid}", now, float(stat.get("nr_throttled", 0))
            )
            if dp is None or dt is None or dp <= 0:
                continue
            ctx.metric_cache.append(
                MetricKind.POD_CPU_THROTTLED_RATIO, {"pod": pod.uid}, now,
                min(dt / dp, 1.0),
            )
        self._periods.forget_missing([f"pod:{p.uid}" for p in pods])
        self._throttled.forget_missing([f"pod:{p.uid}" for p in pods])


#: /proc/diskstats columns (0-indexed after the 3 id fields):
#: 0=reads completed, 2=sectors read, 4=writes completed,
#: 6=sectors written, 9=io_ticks (ms busy)
_SECTOR_BYTES = 512

#: partition device names (sda1, vdb2, nvme0n1p1, mmcblk0p2, xvda1) —
#: the kernel folds partition I/O into the parent disk's counters, so
#: counting both would double-count throughput
_PARTITION_RE = re.compile(
    r"^(?:nvme\d+n\d+p\d+|mmcblk\d+p\d+|(?:[hsv]d|xvd)[a-z]+\d+)$"
)


class NodeStorageInfoCollector:
    """Node disk throughput + io utilization from /proc/diskstats
    (reference: collectors/nodestorageinfo)."""

    name = "nodestorageinfo"

    def __init__(self):
        self._rates = _RateTracker()
        self.ctx: Optional[CollectorContext] = None

    def setup(self, ctx: CollectorContext) -> None:
        self.ctx = ctx

    def _path(self) -> str:
        return os.path.join(self.ctx.system_config.proc_root, "diskstats")

    def enabled(self) -> bool:
        return os.path.exists(self._path())

    def collect(self, now: float) -> None:
        ctx = self.ctx
        try:
            with open(self._path()) as f:
                lines = f.read().splitlines()
        except OSError:
            return
        live = []
        for line in lines:
            parts = line.split()
            if len(parts) < 14:
                continue
            dev = parts[2]
            if _PARTITION_RE.match(dev):
                continue  # whole disks only
            live.append(dev)
            fields = [int(x) for x in parts[3:]]
            read_bps = self._rates.rate(
                f"{dev}:read", now, float(fields[2] * _SECTOR_BYTES)
            )
            write_bps = self._rates.rate(
                f"{dev}:write", now, float(fields[6] * _SECTOR_BYTES)
            )
            util = self._rates.rate(f"{dev}:ticks", now, float(fields[9]))
            labels = {"dev": dev}
            if read_bps is not None:
                ctx.metric_cache.append(
                    MetricKind.NODE_DISK_READ_BPS, labels, now, read_bps
                )
            if write_bps is not None:
                ctx.metric_cache.append(
                    MetricKind.NODE_DISK_WRITE_BPS, labels, now, write_bps
                )
            if util is not None:
                # io_ticks is ms busy per wall second -> percent
                ctx.metric_cache.append(
                    MetricKind.NODE_DISK_IO_UTIL, labels, now,
                    min(util / 10.0, 100.0),
                )
        self._rates.forget_missing(
            [f"{d}:{k}" for d in live for k in ("read", "write", "ticks")]
        )
