"""CPU topology discovery from /proc + /sys.

Reference: pkg/koordlet/util/system/{cpuinfo.go,lscpu.go} — logical
processor → (core, socket, NUMA node) mapping. Parsed from
``/proc/cpuinfo`` (processor / physical id / core id) and
``/sys/devices/system/node/node*/cpulist``; both roots go through
``SystemConfig`` so tests point at a fake tree.

Counterpart of ``koordinator_tpu/koordlet/system/cpuinfo.py``: host work
in numpy and files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import re
from typing import Dict, List, Optional

from koordinator_tpu_torch.koordlet.system.cgroup import CONFIG, SystemConfig


@dataclasses.dataclass(frozen=True)
class ProcessorInfo:
    """One logical cpu (reference: koordletutil.ProcessorInfo)."""

    cpu_id: int
    core_id: int
    socket_id: int
    node_id: int


def parse_cpulist(text: str) -> List[int]:
    """"0-3,8,10-11" → [0,1,2,3,8,10,11] (kernel cpulist format)."""
    out: List[int] = []
    for part in text.strip().split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return out


def _numa_map(cfg: SystemConfig) -> Dict[int, int]:
    """cpu id -> NUMA node id from /sys/devices/system/node."""
    sysfs = getattr(cfg, "sysfs_root", "/sys")
    mapping: Dict[int, int] = {}
    for node_dir in glob.glob(
        os.path.join(sysfs, "devices", "system", "node", "node*")
    ):
        m = re.match(r".*node(\d+)$", node_dir)
        if m is None:
            continue
        node_id = int(m.group(1))
        cpulist = os.path.join(node_dir, "cpulist")
        try:
            with open(cpulist) as f:
                for cpu in parse_cpulist(f.read()):
                    mapping[cpu] = node_id
        except OSError:
            continue
    return mapping


def read_cpu_infos(cfg: Optional[SystemConfig] = None) -> List[ProcessorInfo]:
    """All logical processors with core/socket/NUMA placement."""
    cfg = cfg or CONFIG
    path = os.path.join(cfg.proc_root, "cpuinfo")
    numa = _numa_map(cfg)
    infos: List[ProcessorInfo] = []
    cpu_id = core_id = socket_id = None
    try:
        with open(path) as f:
            lines = list(f) + ["\n"]  # sentinel flush
    except OSError:
        return []
    for line in lines:
        line = line.strip()
        if not line:
            if cpu_id is not None:
                infos.append(
                    ProcessorInfo(
                        cpu_id=cpu_id,
                        core_id=core_id if core_id is not None else cpu_id,
                        socket_id=socket_id or 0,
                        node_id=numa.get(cpu_id, 0),
                    )
                )
            cpu_id = core_id = socket_id = None
            continue
        if ":" not in line:
            continue
        key, value = (x.strip() for x in line.split(":", 1))
        if key == "processor":
            cpu_id = int(value)
        elif key == "core id":
            core_id = int(value)
        elif key == "physical id":
            socket_id = int(value)
    return infos
