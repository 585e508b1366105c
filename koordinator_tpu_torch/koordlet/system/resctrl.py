"""resctrl (Intel RDT / AMD QoS) filesystem abstraction.

Reference: pkg/koordlet/util/system/resctrl.go + resctrl_linux.go —
schemata model (L3 cat + MBA per cache id), the contiguous-cache-way mask
math (CalculateCatL3MaskValue :576-605), vendor-specific MBA rendering
(qosmanager/plugins/resctrl/resctrl_reconcile.go:192-209), and control-
group directory/tasks management. Paths go through ``SystemConfig`` so
tests point at a fake resctrl tree (the reference's Conf redirection).

Counterpart of ``koordinator_tpu/koordlet/system/resctrl.py``: host work
in files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence

from koordinator_tpu_torch.koordlet.system.cgroup import CONFIG, SystemConfig

#: resctrl control groups (reference: resctrl.go:36-41)
LSR_GROUP = "LSR"
LS_GROUP = "LS"
BE_GROUP = "BE"
RESCTRL_GROUPS = (LSR_GROUP, LS_GROUP, BE_GROUP)

#: AMD MBA is absolute GBps per CCD, not percent (resctrl.go)
AMD_CCD_MAX_MB_GBPS = 25 * 1024
AMD_CCD_UNLIMITED_MB = "2048000"


def detect_vendor(proc_root: str = "/proc") -> str:
    """"amd" | "intel" from /proc/cpuinfo vendor_id (GenuineIntel /
    AuthenticAMD); unknown vendors use Intel percent semantics."""
    try:
        with open(os.path.join(proc_root, "cpuinfo")) as f:
            for line in f:
                if line.startswith("vendor_id"):
                    return "amd" if "AuthenticAMD" in line else "intel"
    except OSError:
        pass
    return "intel"


def resctrl_root(cfg: Optional[SystemConfig] = None) -> str:
    cfg = cfg or CONFIG
    # tests place a fake resctrl tree next to the fake cgroup root
    root = getattr(cfg, "resctrl_root", None)
    if root:
        return root
    return os.path.join(os.path.dirname(cfg.cgroup_root.rstrip("/")), "resctrl")


def calculate_cat_l3_mask(cbm: int, start_percent: int, end_percent: int) -> str:
    """Contiguous cache-way mask covering [start%, end%) of the ways
    (reference: CalculateCatL3MaskValue, resctrl.go:576-605)."""
    if bin(cbm + 1).count("1") != 1:
        raise ValueError(f"illegal cbm {cbm:#x}")
    if start_percent < 0 or end_percent > 100 or end_percent <= start_percent:
        raise ValueError(
            f"illegal l3 cat percent: start {start_percent}, end {end_percent}"
        )
    ways = cbm.bit_length()
    start_way = math.ceil(ways * start_percent / 100)
    end_way = math.ceil(ways * end_percent / 100)
    mask = (1 << end_way) - (1 << start_way)
    return format(mask, "x")


def calculate_mba(mba_percent: int, vendor: str = "intel") -> str:
    """Render the MBA schemata value (resctrl_reconcile.go:172-209):
    Intel takes percent in multiples of 10 (rounded up); AMD takes
    absolute MBps per CCD, unlimited at 100%."""
    if vendor == "amd":
        if mba_percent == 100:
            return AMD_CCD_UNLIMITED_MB
        return str(int(AMD_CCD_MAX_MB_GBPS * mba_percent / 100))
    if mba_percent % 10 != 0:
        return str(mba_percent // 10 * 10 + 10)
    return str(mba_percent)


@dataclasses.dataclass
class ResctrlSchemata:
    """One group's schemata: per-cache-id L3 masks + MB values
    (reference: ResctrlSchemataRaw)."""

    l3: Dict[int, str] = dataclasses.field(default_factory=dict)
    mb: Dict[int, str] = dataclasses.field(default_factory=dict)

    def render(self) -> str:
        lines = []
        if self.l3:
            lines.append(
                "L3:" + ";".join(f"{i}={v}" for i, v in sorted(self.l3.items()))
            )
        if self.mb:
            lines.append(
                "MB:" + ";".join(f"{i}={v}" for i, v in sorted(self.mb.items()))
            )
        return "\n".join(lines) + ("\n" if lines else "")

    @classmethod
    def parse(cls, content: str) -> "ResctrlSchemata":
        out = cls()
        for line in content.splitlines():
            line = line.strip()
            if not line or ":" not in line:
                continue
            prefix, rest = line.split(":", 1)
            target = out.l3 if prefix.strip() == "L3" else (
                out.mb if prefix.strip() == "MB" else None
            )
            if target is None:
                continue
            for part in rest.split(";"):
                if "=" in part:
                    i, v = part.split("=", 1)
                    target[int(i)] = v.strip()
        return out


class ResctrlFS:
    """Reads/writes the (possibly fake) resctrl filesystem."""

    def __init__(self, cfg: Optional[SystemConfig] = None):
        self.cfg = cfg

    @property
    def root(self) -> str:
        return resctrl_root(self.cfg)

    def group_dir(self, group: str) -> str:
        return self.root if group == "" else os.path.join(self.root, group)

    def is_supported(self) -> bool:
        return os.path.isdir(self.root) and os.path.exists(
            os.path.join(self.root, "schemata")
        )

    def init_groups(self, groups: Sequence[str] = RESCTRL_GROUPS) -> List[str]:
        """Create missing control-group dirs (initCatResctrl :139-156);
        returns those created."""
        created = []
        for group in groups:
            d = self.group_dir(group)
            if not os.path.isdir(d):
                os.makedirs(d, exist_ok=True)
                created.append(group)
        return created

    def read_cbm(self) -> int:
        """Root L3 cbm mask (info/L3/cbm_mask)."""
        path = os.path.join(self.root, "info", "L3", "cbm_mask")
        with open(path) as f:
            return int(f.read().strip(), 16)

    def cache_ids(self) -> List[int]:
        """Cache ids present in the root schemata's L3 line."""
        schemata = self.read_schemata("")
        if schemata.l3:
            return sorted(schemata.l3)
        if schemata.mb:
            return sorted(schemata.mb)
        return [0]

    def read_schemata(self, group: str) -> ResctrlSchemata:
        path = os.path.join(self.group_dir(group), "schemata")
        if not os.path.exists(path):
            return ResctrlSchemata()
        with open(path) as f:
            return ResctrlSchemata.parse(f.read())

    def write_schemata_line(self, group: str, line: str) -> bool:
        """Write one schemata line (the kernel merges per-prefix lines);
        returns True when the value changed."""
        current = self.read_schemata(group)
        new = ResctrlSchemata.parse(line)
        changed = False
        for i, v in new.l3.items():
            if current.l3.get(i) != v:
                changed = True
        for i, v in new.mb.items():
            if current.mb.get(i) != v:
                changed = True
        if not changed:
            return False
        current.l3.update(new.l3)
        current.mb.update(new.mb)
        path = os.path.join(self.group_dir(group), "schemata")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(current.render())
        return True

    def read_tasks(self, group: str) -> List[int]:
        path = os.path.join(self.group_dir(group), "tasks")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return [int(x) for x in f.read().split() if x.strip()]

    def add_tasks(self, group: str, task_ids: Sequence[int]) -> None:
        """Append task ids (each write moves the task into the group)."""
        if not task_ids:
            return
        path = os.path.join(self.group_dir(group), "tasks")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        existing = set(self.read_tasks(group))
        with open(path, "a") as f:
            for tid in task_ids:
                if tid not in existing:
                    f.write(f"{tid}\n")
