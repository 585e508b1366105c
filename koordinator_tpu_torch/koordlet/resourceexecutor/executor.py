"""Serialized, cached, audited cgroup writer.

Reference: pkg/koordlet/resourceexecutor/{executor.go,updater.go} — all
cgroup mutations in koordlet flow through one executor that:

- skips writes whose value already matches the cached last-written value
  (``cacheable`` updates, executor.go:240 updateByCache);
- supports *merge conditions* for files where an intermediate state must
  stay safe during top-down reconciliation (e.g. only shrink cfs quota
  after children shrank: updater.go:441 MergeConditionIfValueIsLarger,
  MergeConditionIfCFSQuotaIsLarger, MergeConditionIfCPUSetIsLooser);
- runs leveled batches: merge-update top->down, then final-update
  bottom->up (executor.go:114 LeveledUpdateBatch), so parent cgroup
  values are always >= their children's during the transition;
- audits every actual write (updater.go audit.V(3).Record calls).

The reference serializes through a singleton goroutine + cache GC; here
calls are direct (CPython's GIL + single reconcile loop) with the same
cache semantics — entries expire so external drift is re-written.

Counterpart of
``koordinator_tpu/koordlet/resourceexecutor/executor.py``: host work in
numpy and files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from koordinator_tpu_torch.koordlet.audit import Auditor
from koordinator_tpu_torch.koordlet.system.cgroup import (
    CONFIG,
    CgroupResource,
    SystemConfig,
    V1_SUBSYSTEMS,
    get_resource,
)

#: (old_value, new_value) -> (value_to_write, need_write)
MergeCondition = Callable[[str, str], Tuple[str, bool]]


def merge_if_value_larger(old: str, new: str) -> Tuple[str, bool]:
    """Write only when the new integer value is larger (reference:
    updater.go:441 MergeConditionIfValueIsLarger)."""
    try:
        o, n = int(old), int(new)
    except ValueError:
        return new, True
    return new, n > o


def parse_cfs_quota(raw: str) -> Optional[int]:
    """Quota microseconds from a v1 cpu.cfs_quota_us or v2 cpu.max
    content; "max" and -1 both mean unlimited (-1). None if unparsable."""
    try:
        return int(raw.split()[0].replace("max", "-1"))
    except (ValueError, IndexError):
        return None


def merge_if_cfs_quota_larger(old: str, new: str) -> Tuple[str, bool]:
    """cfs_quota: -1 (unlimited) is the largest value (reference:
    updater.go MergeConditionIfCFSQuotaIsLarger)."""
    o = parse_cfs_quota(old)
    try:
        n = int(new)
    except ValueError:
        n = None
    if o is None or n is None:
        return new, True
    if o == -1:
        return new, False
    if n == -1:
        return new, True
    return new, n > o


def _parse_cpuset(value: str) -> frozenset:
    cpus = set()
    for part in value.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-")
            cpus.update(range(int(lo), int(hi) + 1))
        else:
            cpus.add(int(part))
    return frozenset(cpus)


def merge_if_cpuset_looser(old: str, new: str) -> Tuple[str, bool]:
    """cpuset: merge pass writes the union so children never lose their
    current cpus mid-transition (reference: updater.go
    MergeConditionIfCPUSetIsLooser)."""
    try:
        o, n = _parse_cpuset(old), _parse_cpuset(new)
    except ValueError:
        return new, True
    union = o | n
    if union == o:
        return old, False
    merged = ",".join(str(c) for c in sorted(union))
    return merged, True


@dataclasses.dataclass
class CgroupUpdater:
    """One pending write (reference: updater.go CgroupResourceUpdater)."""

    resource_type: str
    parent_dir: str
    value: str
    merge_condition: Optional[MergeCondition] = None
    #: extra cache-key component for files holding multiple independent
    #: entries (device-keyed blkio throttles: one key per device)
    key_extra: str = ""

    def resource(self) -> CgroupResource:
        return get_resource(self.resource_type)

    def key(self, cfg: SystemConfig) -> str:
        # keyed by resource type AND path: distinct resources can share a
        # packed v2 file (cpu.cfs_quota_us and cpu.cfs_period_us both map
        # to cpu.max) and must not collide in the cache
        base = f"{self.resource_type}:{self.resource().path(self.parent_dir, cfg)}"
        return f"{base}:{self.key_extra}" if self.key_extra else base


class ResourceUpdateExecutor:
    """The single write path to cgroupfs."""

    def __init__(
        self,
        config: Optional[SystemConfig] = None,
        auditor: Optional[Auditor] = None,
        cache_ttl: float = 300.0,
        clock=time.time,
    ):
        self.config = config or CONFIG
        self.auditor = auditor or Auditor()
        self.cache_ttl = cache_ttl
        self._clock = clock
        # path -> (value_written, expiry)
        self._cache: Dict[str, Tuple[str, float]] = {}

    # -- cache ---------------------------------------------------------------

    def _cached(self, key: str) -> Optional[str]:
        hit = self._cache.get(key)
        if hit is None:
            return None
        value, expiry = hit
        if self._clock() > expiry:
            del self._cache[key]
            return None
        return value

    def _remember(self, key: str, value: str) -> None:
        self._cache[key] = (value, self._clock() + self.cache_ttl)

    # -- update --------------------------------------------------------------

    def update(self, cacheable: bool, updater: CgroupUpdater,
               merge: bool = False) -> bool:
        """Apply one update; returns True when the file was written.

        ``merge=True`` applies the updater's merge condition against the
        current file content (the top-down pass of a leveled batch).
        """
        resource = updater.resource()
        if self.config.use_cgroup_v2 and resource.v2_file is None:
            return False
        if not resource.validate(updater.value, self.config):
            self.auditor.log(
                "resourceexecutor", updater.key(self.config), "reject",
                f"invalid value {updater.value!r}",
            )
            return False

        path = resource.path(updater.parent_dir, self.config)
        key = updater.key(self.config)
        value = updater.value

        current = None
        if merge and updater.merge_condition is not None:
            # the merge condition needs the live content, and the merged
            # value is what the cache must compare against; v2 content is
            # decoded into v1 conventions first (cpu.weight -> shares,
            # "max" -> -1) so the comparison happens in one value space
            try:
                current = resource.read(updater.parent_dir, self.config)
            except OSError:
                current = ""
            value, need = updater.merge_condition(
                resource.decode(current, self.config), value
            )
            if not need:
                return False
        if cacheable and self._cached(key) == value:
            # cache hit short-circuits BEFORE any read: steady-state
            # reconcile ticks cost zero cgroupfs I/O
            return False
        if current is None:
            # packed v2 files (cpu.max) need the live content to encode
            if self.config.use_cgroup_v2 and resource.v2_encode is not None:
                try:
                    current = resource.read(updater.parent_dir, self.config)
                except OSError:
                    current = ""
            else:
                current = ""

        try:
            content = resource.encode(value, current, self.config)
        except (ValueError, TypeError) as e:
            self.auditor.log(
                "resourceexecutor", path, "reject",
                f"cannot encode {value!r}: {e}",
            )
            return False
        try:
            resource.write(updater.parent_dir, content, self.config)
        except OSError as e:
            self.auditor.log(
                "resourceexecutor", path, "error", f"write failed: {e}"
            )
            return False
        self._remember(key, value)
        self.auditor.log(
            "resourceexecutor", path, "update", f"-> {content!r}"
        )
        from koordinator_tpu_torch.metrics.components import CGROUP_WRITES

        CGROUP_WRITES.inc({"resource": updater.resource_type})
        return True

    def update_batch(self, cacheable: bool,
                     updaters: Sequence[CgroupUpdater]) -> int:
        return sum(
            1 for u in updaters if self.update(cacheable, u)
        )

    def leveled_update_batch(
        self, levels: Sequence[Sequence[CgroupUpdater]]
    ) -> int:
        """Two-phase hierarchy-safe reconcile (reference:
        executor.go:114-190): merge-update from the top level down (values
        only grow/loosen), then plain update from the bottom level up
        (values settle to their targets)."""
        written = 0
        for level in levels:
            for u in level:
                if self.update(True, u, merge=True):
                    written += 1
        for level in reversed(levels):
            for u in level:
                if self.update(True, u):
                    written += 1
        return written


def ensure_cgroup_dir(parent_dir: str, cfg: Optional[SystemConfig] = None,
                      subfs: Sequence[str] = V1_SUBSYSTEMS) -> None:
    """Create the fake-cgroupfs directories for tests (reference:
    testutil NewFileTestUtil.MkDirAll)."""
    cfg = cfg or CONFIG
    if cfg.use_cgroup_v2:
        os.makedirs(os.path.join(cfg.cgroup_root, parent_dir), exist_ok=True)
    else:
        for fs in subfs:
            os.makedirs(
                os.path.join(cfg.cgroup_root, fs, parent_dir), exist_ok=True
            )
