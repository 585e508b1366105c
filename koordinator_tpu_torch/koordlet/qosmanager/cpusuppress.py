"""BE CPU suppression: dynamically shrink what best-effort pods may use.

Reference: pkg/koordlet/qosmanager/plugins/cpusuppress/cpu_suppress.go.
The invariant (cpu_suppress.go:151-163):

  suppress(BE) := node.Capacity * SLOPercent
                  - pod(non-BE).Used
                  - max(system.Used, node.reserved)

with ``system.Used = max(node.Used - Σ pod.Used, 0)``
(helpers/calculator.go:38-80). The budget is applied either as a cpuset
(scatter across NUMA nodes, paired by hyperthread core, never below 2
cpus, growth rate-limited to ceil(10%) of the node's cpus per round —
cpu_suppress.go:653 calculateBESuppressCPUSetPolicy, :392) or as a cfs
quota on the BE tier cgroup (quota = mCPU * period / 1000, min 2000us,
small deltas bypassed, increases capped at 10% of capacity per round —
cpu_suppress.go:589-628 adjustByCfsQuota).

Cpuset writes are hierarchy-safe: union first from upper to lower, then
the real target from lower to upper (applyCPUSetWithNonePolicy) — here
via the executor's leveled merge batch.

Counterpart of ``koordinator_tpu/koordlet/qosmanager/cpusuppress.py``:
host work in files, bit for bit the reference's.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from koordinator_tpu_torch.apis.extension import QoSClass
from koordinator_tpu_torch.koordlet.metriccache import AggregationType, MetricKind
from koordinator_tpu_torch.koordlet.qosmanager.framework import CPUInfo, QoSContext
from koordinator_tpu_torch.koordlet.resourceexecutor import (
    CgroupUpdater,
    merge_if_cpuset_looser,
)
from koordinator_tpu_torch.koordlet.resourceexecutor.executor import (
    _parse_cpuset,
    parse_cfs_quota,
)
from koordinator_tpu_torch.koordlet.system.cgroup import (
    CFS_PERIOD_US,
    CPU_CFS_QUOTA,
    CPU_SET,
)

BE_MIN_QUOTA_US = 2000
SUPPRESS_BYPASS_QUOTA_DELTA_RATIO = 0.01
BE_MAX_INCREASE_CPU_PERCENT = 0.1


def calculate_be_suppress_mcpu(
    capacity_mcpu: int,
    threshold_percent: int,
    node_used_mcpu: float,
    pod_used_mcpu: Dict[str, float],
    non_be_uids: set,
    reserved_mcpu: int,
) -> int:
    """The suppress budget in mCPU (cpu_suppress.go:137-163)."""
    all_used = sum(pod_used_mcpu.values())
    non_be_used = sum(
        u for uid, u in pod_used_mcpu.items() if uid in non_be_uids
    )
    system_used = max(node_used_mcpu - all_used, 0.0)
    system_or_reserved = max(system_used, float(reserved_mcpu))
    budget = (
        capacity_mcpu * threshold_percent / 100.0
        - non_be_used
        - system_or_reserved
    )
    return int(budget)


def select_suppress_cpus(
    want_cpus: int, cpu_infos: List[CPUInfo], old_count: int
) -> List[int]:
    """Pick cpu ids for the BE cpuset: scattered across NUMA nodes,
    hyperthread-paired, at least 2, growth rate-limited
    (cpu_suppress.go:653 + :392 beMaxIncreaseCpuNum)."""
    n = len(cpu_infos)
    if n == 0:
        return []
    max_increase = math.ceil(n * BE_MAX_INCREASE_CPU_PERCENT)
    if old_count > 0 and want_cpus > old_count + max_increase:
        want_cpus = old_count + max_increase
    want_cpus = max(2, min(want_cpus, n))

    # bucket per (numa node, socket), each sorted by (core, cpu) so HT
    # siblings are adjacent
    buckets: Dict[Tuple[int, int], List[CPUInfo]] = {}
    for info in cpu_infos:
        buckets.setdefault((info.node_id, info.socket_id), []).append(info)
    ordered = sorted(
        (sorted(b, key=lambda c: (c.core_id, c.cpu_id))
         for b in buckets.values()),
        key=lambda b: (-len(b), b[0].cpu_id),
    )

    picked: List[int] = []
    picked_set = set()
    # round-robin: take a full HT core pair from each bucket in turn
    progress = True
    while len(picked) + 1 < want_cpus and progress:
        progress = False
        for bucket in ordered:
            if len(picked) + 1 >= want_cpus:
                break
            for i in range(len(bucket) - 1):
                a, b = bucket[i], bucket[i + 1]
                if a.cpu_id in picked_set or b.cpu_id in picked_set:
                    continue
                if a.core_id == b.core_id:
                    picked.extend([a.cpu_id, b.cpu_id])
                    picked_set.update([a.cpu_id, b.cpu_id])
                    progress = True
                    break
    if len(picked) < want_cpus:
        for bucket in ordered:
            for info in bucket:
                if len(picked) >= want_cpus:
                    break
                if info.cpu_id not in picked_set:
                    picked.append(info.cpu_id)
                    picked_set.add(info.cpu_id)
    return sorted(picked)


def cpuset_str(cpu_ids: List[int]) -> str:
    return ",".join(str(c) for c in sorted(cpu_ids))


class CPUSuppress:
    """The strategy plugin."""

    name = "cpusuppress"
    interval_seconds = 1.0

    def __init__(self):
        self._suppressed_policy: Dict[str, bool] = {}

    def enabled(self, ctx: QoSContext) -> bool:
        return True

    # -- helpers -------------------------------------------------------------

    def _be_cpuset_dirs(self, ctx: QoSContext) -> List[List[str]]:
        """BE cgroup dirs by level: [tier], [pods], [containers]."""
        tier = [ctx.be_cgroup_dir]
        pods, containers = [], []
        for pod in ctx.pod_provider.running_pods():
            if pod.qos is QoSClass.BE:
                pods.append(pod.cgroup_dir)
                containers.extend(pod.containers.values())
        return [lvl for lvl in (tier, pods, containers) if lvl]

    def _latest(self, ctx: QoSContext, kind: MetricKind,
                labels=None, now: float = 0.0) -> Optional[float]:
        return ctx.metric_cache.aggregate(
            kind, labels, start=now - ctx.metric_collect_interval, end=now,
            agg=AggregationType.LAST,
        )

    # -- main ----------------------------------------------------------------

    def execute(self, ctx: QoSContext, now: float) -> None:
        threshold = ctx.node_slo.resource_used_threshold_with_be
        if not threshold.enable:
            self._recover_cfs_quota(ctx)
            self._recover_cpuset(ctx)
            return

        node_used = self._latest(ctx, MetricKind.NODE_CPU_USAGE, now=now)
        if node_used is None:
            return
        pods = list(ctx.pod_provider.running_pods())
        pod_used: Dict[str, float] = {}
        non_be = set()
        for pod in pods:
            u = self._latest(
                ctx, MetricKind.POD_CPU_USAGE, {"pod": pod.uid}, now=now
            )
            if u is not None:
                pod_used[pod.uid] = u
            if pod.qos is not QoSClass.BE:
                non_be.add(pod.uid)

        budget_mcpu = calculate_be_suppress_mcpu(
            ctx.node_capacity_mcpu,
            threshold.cpu_suppress_threshold_percent,
            node_used, pod_used, non_be, ctx.node_reserved_mcpu,
        )

        if threshold.cpu_suppress_policy == "cfsQuota":
            self._adjust_by_cfs_quota(ctx, budget_mcpu)
            self._recover_cpuset(ctx)
        else:
            self._adjust_by_cpuset(ctx, budget_mcpu)
            self._recover_cfs_quota(ctx)

    # -- cpuset policy -------------------------------------------------------

    def _adjust_by_cpuset(self, ctx: QoSContext, budget_mcpu: int) -> None:
        try:
            old = CPU_SET.read(ctx.be_cgroup_dir, ctx.system_config)
        except OSError:
            old = ""
        # kernel normalizes cpuset to range syntax ("0-63"): parse, don't
        # count commas
        try:
            old_count = len(_parse_cpuset(old))
        except ValueError:
            old_count = 0
        # reference rounds the BE cpuset size UP (cpu_suppress.go:388
        # math.Ceil), so a non-integral budget still grants the extra CPU
        want = -(-budget_mcpu // 1000)
        cpus = select_suppress_cpus(want, ctx.cpu_infos, old_count)
        if not cpus:
            return
        target = cpuset_str(cpus)
        levels = [
            [CgroupUpdater("cpuset.cpus", d, target, merge_if_cpuset_looser)
             for d in level]
            for level in self._be_cpuset_dirs(ctx)
        ]
        ctx.executor.leveled_update_batch(levels)
        self._suppressed_policy["cpuset"] = True
        ctx.log("qosmanager/cpusuppress", ctx.be_cgroup_dir, "suppress",
                f"cpuset -> {target}")

    def _recover_cpuset(self, ctx: QoSContext) -> None:
        if not self._suppressed_policy.get("cpuset"):
            return
        all_cpus = cpuset_str([c.cpu_id for c in ctx.cpu_infos])
        if not all_cpus:
            return
        levels = [
            [CgroupUpdater("cpuset.cpus", d, all_cpus,
                           merge_if_cpuset_looser) for d in level]
            for level in self._be_cpuset_dirs(ctx)
        ]
        ctx.executor.leveled_update_batch(levels)
        self._suppressed_policy["cpuset"] = False
        ctx.log("qosmanager/cpusuppress", ctx.be_cgroup_dir, "recover",
                "cpuset restored")

    # -- cfs quota policy ----------------------------------------------------

    def _adjust_by_cfs_quota(self, ctx: QoSContext, budget_mcpu: int) -> None:
        new_quota = max(budget_mcpu * CFS_PERIOD_US // 1000, BE_MIN_QUOTA_US)
        try:
            raw = CPU_CFS_QUOTA.read(ctx.be_cgroup_dir, ctx.system_config)
        except OSError:
            raw = ""
        cur = parse_cfs_quota(raw)
        if cur is None:
            cur = -1

        capacity_cores = ctx.node_capacity_mcpu / 1000.0
        min_delta = capacity_cores * CFS_PERIOD_US * (
            SUPPRESS_BYPASS_QUOTA_DELTA_RATIO
        )
        if cur > 0 and abs(new_quota - cur) < min_delta and (
            new_quota != BE_MIN_QUOTA_US
        ):
            return
        max_increase = capacity_cores * CFS_PERIOD_US * (
            BE_MAX_INCREASE_CPU_PERCENT
        )
        if cur > 0 and new_quota - cur > max_increase:
            new_quota = cur + int(max_increase)
        ctx.executor.update(False, CgroupUpdater(
            "cpu.cfs_quota_us", ctx.be_cgroup_dir, str(new_quota)))
        self._suppressed_policy["cfsQuota"] = True
        ctx.log("qosmanager/cpusuppress", ctx.be_cgroup_dir, "suppress",
                f"cfs quota -> {new_quota}")

    def _recover_cfs_quota(self, ctx: QoSContext) -> None:
        if not self._suppressed_policy.get("cfsQuota"):
            return
        ctx.executor.update(False, CgroupUpdater(
            "cpu.cfs_quota_us", ctx.be_cgroup_dir, "-1"))
        self._suppressed_policy["cfsQuota"] = False
        ctx.log("qosmanager/cpusuppress", ctx.be_cgroup_dir, "recover",
                "cfs quota unlimited")
