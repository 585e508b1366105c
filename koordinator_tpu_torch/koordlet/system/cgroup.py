"""Typed cgroup v1/v2 resource registry with path redirection.

Reference: pkg/koordlet/util/system/cgroup_resource.go (the registry),
cgroup.go / cgroup2.go (v1/v2 read-write + conversions). A ``Resource``
knows its v1 subsystem+filename, its v2 filename, its value validator,
and — where the v2 file format differs (cpu.max packs quota+period;
cpu.weight rescales cpu.shares) — how to encode/decode values. Writers
go through ``resourceexecutor`` which adds caching/merging/audit.

Every path resolves under ``SystemConfig.cgroup_root`` so tests point the
whole stack at a fake cgroupfs in a temp dir (reference:
system.Conf.CgroupRootDir redirection + NewFileTestUtil).

Counterpart of ``koordinator_tpu/koordlet/system/cgroup.py``: host work
in numpy and files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Callable, Dict, List, Optional, Tuple


class CgroupVersion(enum.Enum):
    V1 = 1
    V2 = 2


#: v1 hierarchies this framework manages.
V1_SUBSYSTEMS = ("cpu", "cpuacct", "cpuset", "memory", "blkio")

#: kernel cfs period in microseconds; quota and burst math in the
#: suppress/evict/burst strategies must all use the same value.
CFS_PERIOD_US = 100000


@dataclasses.dataclass
class SystemConfig:
    """Host paths + cgroup driver config (reference:
    pkg/koordlet/util/system/config.go system.Conf)."""

    cgroup_root: str = "/sys/fs/cgroup"
    proc_root: str = "/proc"
    sysfs_root: str = "/sys"
    use_cgroup_v2: bool = False
    #: cgroup path prefix for the kubepods hierarchy
    kubepods_dir: str = "kubepods"
    #: terway net-QoS dataplane config dir (reference:
    #: runtimehooks/hooks/terwayqos rootPath "/host-var-lib/terway/qos")
    terway_qos_root: str = "/host-var-lib/terway/qos"


#: Module-level active config; tests replace it (reference: system.Conf).
CONFIG = SystemConfig()


def set_config(cfg: SystemConfig) -> None:
    global CONFIG
    CONFIG = cfg


# -- validators -------------------------------------------------------------

Validator = Callable[[str], bool]


def _range_validator(lo: int, hi: int) -> Validator:
    def check(value: str) -> bool:
        try:
            v = int(value)
        except ValueError:
            return False
        return lo <= v <= hi

    return check


def _natural_int64(value: str) -> bool:
    try:
        v = int(value)
    except ValueError:
        return value == "max"  # v2 files accept "max"
    return 0 <= v <= 2**63 - 1


def _any_int(value: str) -> bool:
    try:
        int(value)
        return True
    except ValueError:
        return value == "max"


def _cpuset_validator(value: str) -> bool:
    # "0-3,8,10-11" or empty
    if value == "":
        return True
    try:
        for part in value.split(","):
            if "-" in part:
                lo, hi = part.split("-")
                if int(lo) > int(hi):
                    return False
            else:
                int(part)
        return True
    except ValueError:
        return False


#: cpu.shares bounds (reference: cgroup.go CPUSharesMinValue/MaxValue)
CPU_SHARES_MIN, CPU_SHARES_MAX = 2, 262144
#: cpu.weight bounds (reference: cgroup2.go CPUWeightMinValue/MaxValue)
CPU_WEIGHT_MIN, CPU_WEIGHT_MAX = 1, 10000


def convert_cpu_shares_to_weight(shares: int) -> int:
    """Kubelet's v1->v2 mapping: weight = 1 + (shares-2)*9999/262142
    (reference: cgroup2.go:302-315, KEP-2254)."""
    w = 1 + ((shares - 2) * 9999) // 262142
    return max(CPU_WEIGHT_MIN, min(CPU_WEIGHT_MAX, w))


def convert_cpu_weight_to_shares(weight: int) -> int:
    """Inverse mapping: shares = (weight-1)*262142/9999 + 2
    (reference: cgroup2.go:283-300)."""
    s = (weight - 1) * 262142 // 9999 + 2
    return max(CPU_SHARES_MIN, min(CPU_SHARES_MAX, s))


# -- resource ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CgroupResource:
    """One cgroup interface file, v1+v2 aware.

    ``resource_type`` is the canonical name (the v1 filename, as in the
    reference's ResourceType). ``v2_file=None`` means unsupported on v2.
    """

    resource_type: str
    v1_subfs: str                 # "cpu" | "cpuset" | "memory" | "blkio"
    v1_file: str
    v2_file: Optional[str] = None
    validator: Optional[Validator] = None
    #: v2 validator when the v2 value space differs (cpu.weight)
    v2_validator: Optional[Validator] = None
    #: encode a v1-convention value into the v2 file's format; receives
    #: (value, current_v2_content) for read-modify-write files (cpu.max)
    v2_encode: Optional[Callable[[str, str], str]] = None
    #: normalize a value for the v1 file (e.g. "max" -> "-1")
    v1_encode: Optional[Callable[[str], str]] = None
    #: decode raw v2 file content back into the v1-convention value space
    #: (cpu.weight -> shares, "max" -> "-1"); merge conditions compare in
    #: v1 conventions
    v2_decode: Optional[Callable[[str], str]] = None
    #: on v1 this file exists independently in EVERY hierarchy and a
    #: write must hit all of them (cgroup.procs: moving a task in only
    #: the cpu hierarchy leaves it in the old cpuset/memory cgroups)
    v1_all_subfs: bool = False

    def supported(self, version: CgroupVersion) -> bool:
        return version is CgroupVersion.V1 or self.v2_file is not None

    def path(self, parent_dir: str, cfg: Optional[SystemConfig] = None) -> str:
        """Absolute path of this file for the cgroup at ``parent_dir``
        (e.g. "kubepods/burstable/pod123"). v1 nests under the
        subsystem mount; v2 is unified."""
        cfg = cfg or CONFIG
        if cfg.use_cgroup_v2:
            if self.v2_file is None:
                raise FileNotFoundError(
                    f"{self.resource_type} unsupported on cgroup v2"
                )
            return os.path.join(cfg.cgroup_root, parent_dir, self.v2_file)
        return os.path.join(
            cfg.cgroup_root, self.v1_subfs, parent_dir, self.v1_file
        )

    def paths(self, parent_dir: str,
              cfg: Optional[SystemConfig] = None) -> List[str]:
        """All file paths a write must reach (one, except v1_all_subfs)."""
        cfg = cfg or CONFIG
        if cfg.use_cgroup_v2 or not self.v1_all_subfs:
            return [self.path(parent_dir, cfg)]
        return [
            os.path.join(cfg.cgroup_root, fs, parent_dir, self.v1_file)
            for fs in V1_SUBSYSTEMS
        ]

    def validate(self, value: str, cfg: Optional[SystemConfig] = None) -> bool:
        cfg = cfg or CONFIG
        v = (
            self.v2_validator
            if cfg.use_cgroup_v2 and self.v2_validator is not None
            else self.validator
        )
        return v is None or v(value)

    def encode(self, value: str, current: str,
               cfg: Optional[SystemConfig] = None) -> str:
        """Final file content for writing ``value`` (v1 conventions) given
        the file's ``current`` content (v2 packed files)."""
        cfg = cfg or CONFIG
        if cfg.use_cgroup_v2:
            if self.v2_encode is not None:
                return self.v2_encode(value, current)
            return value
        if self.v1_encode is not None:
            return self.v1_encode(value)
        return value

    def decode(self, content: str,
               cfg: Optional[SystemConfig] = None) -> str:
        """v1-convention value from raw file content (inverse of encode;
        identity on v1 and for files whose formats match)."""
        cfg = cfg or CONFIG
        if cfg.use_cgroup_v2 and self.v2_decode is not None:
            try:
                return self.v2_decode(content)
            except (ValueError, IndexError):
                return content
        return content

    def read(self, parent_dir: str, cfg: Optional[SystemConfig] = None) -> str:
        with open(self.path(parent_dir, cfg)) as f:
            return f.read().strip()

    def write(self, parent_dir: str, content: str,
              cfg: Optional[SystemConfig] = None) -> None:
        paths = self.paths(parent_dir, cfg)
        if len(paths) == 1:
            with open(paths[0], "w") as f:
                f.write(content)
            return
        # multi-hierarchy (cgroup.procs): a hierarchy that is not mounted
        # or lacks this cgroup dir is skipped — raising midway would leave
        # the task split across old/new cgroups with no way to converge
        first_err: Optional[OSError] = None
        wrote = False
        for p in paths:
            try:
                with open(p, "w") as f:
                    f.write(content)
                wrote = True
            except OSError as e:
                if first_err is None:
                    first_err = e
        if not wrote and first_err is not None:
            raise first_err


# -- v2 packed-file encoders -------------------------------------------------


def _cpu_max_parts(current: str) -> Tuple[str, str]:
    parts = current.split()
    quota = parts[0] if parts else "max"
    period = parts[1] if len(parts) > 1 else "100000"
    return quota, period


def _encode_cfs_quota(value: str, current: str) -> str:
    # v1 quota -1 means unlimited -> v2 "max" (reference: cgroup2.go cpu.max)
    quota, period = _cpu_max_parts(current)
    new_quota = "max" if value == "max" or int(value) < 0 else value
    return f"{new_quota} {period}"


def _encode_cfs_period(value: str, current: str) -> str:
    quota, _ = _cpu_max_parts(current)
    return f"{quota} {value}"


def _encode_cpu_shares(value: str, current: str) -> str:
    return str(convert_cpu_shares_to_weight(int(value)))


# -- the registry (reference: cgroup_resource.go:206-330) -------------------

CPU_SHARES = CgroupResource(
    "cpu.shares", "cpu", "cpu.shares", "cpu.weight",
    validator=_range_validator(CPU_SHARES_MIN, CPU_SHARES_MAX),
    v2_validator=_range_validator(CPU_SHARES_MIN, CPU_SHARES_MAX),
    v2_encode=_encode_cpu_shares,
    v2_decode=lambda c: str(convert_cpu_weight_to_shares(int(c))),
)
CPU_CFS_QUOTA = CgroupResource(
    "cpu.cfs_quota_us", "cpu", "cpu.cfs_quota_us", "cpu.max",
    validator=_any_int, v2_encode=_encode_cfs_quota,
    v1_encode=lambda v: "-1" if v == "max" else v,
    v2_decode=lambda c: c.split()[0].replace("max", "-1"),
)
CPU_CFS_PERIOD = CgroupResource(
    "cpu.cfs_period_us", "cpu", "cpu.cfs_period_us", "cpu.max",
    validator=_range_validator(1000, 1_000_000), v2_encode=_encode_cfs_period,
)
CPU_BURST = CgroupResource(
    "cpu.cfs_burst_us", "cpu", "cpu.cfs_burst_us", "cpu.max.burst",
    validator=_natural_int64,
)
#: group identity / bvt (Anolis kernel; reference: cgroup_resource.go:210)
CPU_BVT_WARP_NS = CgroupResource(
    "cpu.bvt_warp_ns", "cpu", "cpu.bvt_warp_ns", "cpu.bvt_warp_ns",
    validator=_range_validator(-1, 2),
)
CPU_IDLE = CgroupResource(
    "cpu.idle", "cpu", "cpu.idle", "cpu.idle",
    validator=_range_validator(0, 1),
)
CPU_SET = CgroupResource(
    "cpuset.cpus", "cpuset", "cpuset.cpus", "cpuset.cpus",
    validator=_cpuset_validator,
)
CPU_PROCS = CgroupResource(
    "cgroup.procs", "cpu", "cgroup.procs", "cgroup.procs",
    validator=_natural_int64, v1_all_subfs=True,
)
MEMORY_LIMIT = CgroupResource(
    "memory.limit_in_bytes", "memory", "memory.limit_in_bytes", "memory.max",
    validator=_any_int,
    v2_encode=lambda v, cur: "max" if v == "max" or int(v) < 0 else v,
    v1_encode=lambda v: "-1" if v == "max" else v,
    v2_decode=lambda c: "-1" if c == "max" else c,
)
MEMORY_MIN = CgroupResource(
    "memory.min", "memory", "memory.min", "memory.min",
    validator=_natural_int64,
)
MEMORY_LOW = CgroupResource(
    "memory.low", "memory", "memory.low", "memory.low",
    validator=_natural_int64,
)
MEMORY_HIGH = CgroupResource(
    "memory.high", "memory", "memory.high", "memory.high",
    validator=lambda v: v == "max" or _natural_int64(v),
)
MEMORY_WMARK_RATIO = CgroupResource(
    "memory.wmark_ratio", "memory", "memory.wmark_ratio",
    "memory.wmark_ratio", validator=_range_validator(0, 100),
)
MEMORY_WMARK_SCALE_FACTOR = CgroupResource(
    "memory.wmark_scale_factor", "memory", "memory.wmark_scale_factor",
    "memory.wmark_scale_factor", validator=_range_validator(1, 1000),
)
MEMORY_PRIORITY = CgroupResource(
    "memory.priority", "memory", "memory.priority", "memory.priority",
    validator=_range_validator(0, 12),
)
MEMORY_OOM_GROUP = CgroupResource(
    "memory.oom.group", "memory", "memory.oom.group", "memory.oom.group",
    validator=_range_validator(0, 1),
)
MEMORY_USAGE = CgroupResource(
    "memory.usage_in_bytes", "memory", "memory.usage_in_bytes",
    "memory.current",
)
#: cumulative cpu time: v1 cpuacct.usage is nanoseconds; v2 cpu.stat has
#: a "usage_usec N" line (callers parse per version)
CPU_ACCT_USAGE = CgroupResource(
    "cpuacct.usage", "cpuacct", "cpuacct.usage", "cpu.stat",
)
#: cfs throttling stats (nr_periods/nr_throttled/throttled_time) — the
#: podthrottled collector's source; same key/value format on v1 and v2
CPU_STAT = CgroupResource(
    "cpu.stat", "cpu", "cpu.stat", "cpu.stat",
)
BLKIO_IO_WEIGHT = CgroupResource(
    "blkio.cost.weight", "blkio", "blkio.cost.weight", "io.cost.weight",
    validator=_range_validator(1, 100),
)


def _device_value(value: str) -> bool:
    """"MAJ:MIN N" (or "MAJ:MIN max") device throttle entries."""
    parts = value.split()
    if len(parts) != 2 or ":" not in parts[0]:
        return False
    return parts[1] == "max" or parts[1].isdigit()


def _io_max_encode(key: str):
    """Pack a v1-style "MAJ:MIN N" throttle into the v2 ``io.max`` file,
    merging with the other keys already present for the device."""

    def enc(value: str, current: str) -> str:
        dev, val = value.split()
        entries: Dict[str, Dict[str, str]] = {}
        for line in current.splitlines():
            parts = line.split()
            if not parts:
                continue
            entries[parts[0]] = dict(
                kv.split("=", 1) for kv in parts[1:] if "=" in kv
            )
        entry = entries.setdefault(dev, {})
        entry[key] = "max" if val in ("max", "-1", "0") else val
        return "\n".join(
            f"{d} " + " ".join(f"{k}={v}" for k, v in sorted(e.items()))
            for d, e in sorted(entries.items())
        )

    return enc


#: blkio throttling (reference: blkio_reconcile.go throttle files;
#: cgroup v2 packs all four into io.max)
BLKIO_READ_BPS = CgroupResource(
    "blkio.throttle.read_bps_device", "blkio",
    "blkio.throttle.read_bps_device", "io.max",
    validator=_device_value, v2_encode=_io_max_encode("rbps"),
)
BLKIO_WRITE_BPS = CgroupResource(
    "blkio.throttle.write_bps_device", "blkio",
    "blkio.throttle.write_bps_device", "io.max",
    validator=_device_value, v2_encode=_io_max_encode("wbps"),
)
BLKIO_READ_IOPS = CgroupResource(
    "blkio.throttle.read_iops_device", "blkio",
    "blkio.throttle.read_iops_device", "io.max",
    validator=_device_value, v2_encode=_io_max_encode("riops"),
)
BLKIO_WRITE_IOPS = CgroupResource(
    "blkio.throttle.write_iops_device", "blkio",
    "blkio.throttle.write_iops_device", "io.max",
    validator=_device_value, v2_encode=_io_max_encode("wiops"),
)

_KNOWN: List[CgroupResource] = [
    CPU_SHARES, CPU_CFS_QUOTA, CPU_CFS_PERIOD, CPU_BURST, CPU_BVT_WARP_NS,
    CPU_IDLE, CPU_SET, CPU_PROCS, MEMORY_LIMIT, MEMORY_MIN, MEMORY_LOW,
    MEMORY_HIGH, MEMORY_WMARK_RATIO, MEMORY_WMARK_SCALE_FACTOR,
    MEMORY_PRIORITY, MEMORY_OOM_GROUP, MEMORY_USAGE, BLKIO_IO_WEIGHT,
    BLKIO_READ_BPS, BLKIO_WRITE_BPS, BLKIO_READ_IOPS, BLKIO_WRITE_IOPS,
    CPU_ACCT_USAGE, CPU_STAT,
]
_BY_TYPE: Dict[str, CgroupResource] = {r.resource_type: r for r in _KNOWN}


def get_resource(resource_type: str) -> CgroupResource:
    """Lookup by canonical name (reference: GetCgroupResource)."""
    r = _BY_TYPE.get(resource_type)
    if r is None:
        raise KeyError(f"unknown cgroup resource {resource_type!r}")
    return r


def known_resources() -> List[CgroupResource]:
    return list(_KNOWN)
