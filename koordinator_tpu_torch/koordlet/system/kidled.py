"""kidled cold-page accounting (Alibaba Cloud-kernel idle-page tracking).

Reference: pkg/koordlet/util/system/kidled_util.go — the kernel module
exposes ``/sys/kernel/mm/kidled/{scan_period_in_seconds,use_hierarchy}``
and per-cgroup ``memory.idle_page_stats`` histograms: one row per page
class (cfei/dfei/cfui/dfui/... = clean/dirty × file/slab × evictable/
unevictable × idle), bucketed by idle age. Cold bytes = Σ of the four
file-backed idle classes from the cold boundary bucket onward
(GetColdPageTotalBytes :138-141, kidledColdBoundary).

Counterpart of ``koordinator_tpu/koordlet/system/kidled.py``: host work
in numpy and files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from koordinator_tpu_torch.koordlet.system.cgroup import CONFIG, SystemConfig

#: the page classes counted as reclaimable cold pages (:138)
COLD_PAGE_CLASSES = ("cfei", "dfei", "cfui", "dfui")

#: default boundary bucket (idle >= 5 scan periods; kidled_util.go:34)
DEFAULT_COLD_BOUNDARY = 3


@dataclasses.dataclass
class IdlePageStats:
    """Parsed memory.idle_page_stats."""

    scan_period_seconds: int = 0
    use_hierarchy: int = 0
    buckets: List[int] = dataclasses.field(default_factory=list)
    #: page class -> per-bucket bytes
    classes: Dict[str, List[int]] = dataclasses.field(default_factory=dict)

    def cold_page_bytes(self, boundary: int = DEFAULT_COLD_BOUNDARY) -> int:
        total = 0
        for name in COLD_PAGE_CLASSES:
            total += sum(self.classes.get(name, [])[boundary:])
        return total


def parse_idle_page_stats(content: str) -> IdlePageStats:
    """Parse the kidled histogram file: header lines
    ``# key: value`` (version/scan period/use_hierarchy/buckets), then
    ``<class> v0 v1 ...`` rows per page class."""
    stats = IdlePageStats()
    for line in content.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            fields = line[1:].split()
            if len(fields) < 2:
                continue
            key = fields[0].rstrip(":")
            if key == "scan_period_in_seconds":
                stats.scan_period_seconds = int(fields[1])
            elif key == "use_hierarchy":
                stats.use_hierarchy = int(fields[1])
            elif key == "buckets":
                stats.buckets = [int(x) for x in fields[1].split(",") if x]
            continue
        fields = line.split()
        stats.classes[fields[0]] = [int(x) for x in fields[1:]]
    return stats


class Kidled:
    """The kidled control files + per-cgroup stats reader."""

    def __init__(self, cfg: Optional[SystemConfig] = None):
        self.cfg = cfg or CONFIG

    @property
    def root(self) -> str:
        sysfs = getattr(self.cfg, "sysfs_root", "/sys")
        return os.path.join(sysfs, "kernel", "mm", "kidled")

    def supported(self) -> bool:
        return os.path.exists(os.path.join(self.root, "scan_period_in_seconds"))

    def set_scan_period(self, seconds: int) -> None:
        with open(os.path.join(self.root, "scan_period_in_seconds"), "w") as f:
            f.write(str(int(seconds)))

    def set_use_hierarchy(self, use: bool) -> None:
        with open(os.path.join(self.root, "use_hierarchy"), "w") as f:
            f.write("1" if use else "0")

    def read_stats(self, cgroup_dir: str = "") -> Optional[IdlePageStats]:
        sub = "" if self.cfg.use_cgroup_v2 else "memory"
        path = os.path.join(
            self.cfg.cgroup_root, sub, cgroup_dir, "memory.idle_page_stats"
        )
        try:
            with open(path) as f:
                return parse_idle_page_stats(f.read())
        except (OSError, ValueError, IndexError):
            # unreadable or malformed stats must not crash the tick
            return None
