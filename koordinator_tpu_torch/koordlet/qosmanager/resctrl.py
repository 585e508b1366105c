"""ResctrlReconcile: LLC (L3 CAT) + memory-bandwidth (MBA) isolation per
QoS tier.

Reference: pkg/koordlet/qosmanager/plugins/resctrl/resctrl_reconcile.go —
three resctrl control groups (LSR, LS, BE; :109-122 getPodResctrlGroup
maps LSE/LSR→LSR, LS→LS, BE→BE), each reconciled to its strategy's cache
way range (calculateAndApplyRDTL3PolicyForGroup :293) and MBA percent
(:329), then every pod's tasks are pulled into its group's tasks file
(:211-292).

Counterpart of ``koordinator_tpu/koordlet/qosmanager/resctrl.py``: host
work in files, bit for bit the reference's.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from koordinator_tpu_torch.apis.extension import QoSClass
from koordinator_tpu_torch.koordlet.qosmanager.framework import QoSContext
from koordinator_tpu_torch.koordlet.system.resctrl import (
    BE_GROUP,
    LS_GROUP,
    LSR_GROUP,
    RESCTRL_GROUPS,
    ResctrlFS,
    calculate_cat_l3_mask,
    calculate_mba,
    detect_vendor,
)

_QOS_TO_GROUP = {
    QoSClass.LSE: LSR_GROUP,
    QoSClass.LSR: LSR_GROUP,
    QoSClass.LS: LS_GROUP,
    QoSClass.BE: BE_GROUP,
}

_GROUP_TO_QOS = {
    LSR_GROUP: QoSClass.LSR,
    LS_GROUP: QoSClass.LS,
    BE_GROUP: QoSClass.BE,
}


def pod_resctrl_group(qos: QoSClass) -> str:
    """getPodResctrlGroup (:109-122); "" = unknown (left alone)."""
    return _QOS_TO_GROUP.get(qos, "")


class ResctrlReconcile:
    name = "resctrl"
    interval_seconds = 10.0

    def __init__(self, fs: Optional[ResctrlFS] = None,
                 vendor: Optional[str] = None):
        self._fs = fs
        #: None = detect from /proc/cpuinfo at first execute (AMD's MBA
        #: takes absolute MBps, Intel's takes percent — writing the wrong
        #: convention throttles drastically)
        self.vendor = vendor

    def _vendor_for(self, ctx: QoSContext) -> str:
        if self.vendor is None:
            self.vendor = detect_vendor(ctx.system_config.proc_root)
        return self.vendor

    def _fs_for(self, ctx: QoSContext) -> ResctrlFS:
        # bind to the context's SystemConfig unless explicitly injected,
        # so the resctrl tree and the cgroup tree stay consistent
        if self._fs is None:
            self._fs = ResctrlFS(ctx.system_config)
        return self._fs

    @property
    def fs(self) -> ResctrlFS:
        assert self._fs is not None
        return self._fs

    def enabled(self, ctx: QoSContext) -> bool:
        return self._fs_for(ctx).is_supported()

    def execute(self, ctx: QoSContext, now: float) -> None:
        fs = self._fs_for(ctx)
        try:
            fs.init_groups()
            cbm = fs.read_cbm()
            cache_ids = fs.cache_ids()
        except (OSError, ValueError):
            return
        strategy = ctx.node_slo.resource_qos_strategy
        for group in RESCTRL_GROUPS:
            qos_cfg = strategy.for_qos(_GROUP_TO_QOS[group])
            resctrl = qos_cfg.resctrl
            # a kernel rejection (e.g. CAT-only host refusing MB lines)
            # must not abort the reconcile pass or the manager tick
            try:
                self._apply_l3(ctx, group, cbm, cache_ids, resctrl)
            except OSError:
                pass
            try:
                self._apply_mb(ctx, group, cache_ids, resctrl)
            except OSError:
                pass
        self._move_tasks(ctx)

    # -- policy (:293-343) --------------------------------------------------

    def _apply_l3(self, ctx, group, cbm, cache_ids, resctrl) -> None:
        try:
            mask = calculate_cat_l3_mask(
                cbm,
                resctrl.cat_range_start_percent,
                resctrl.cat_range_end_percent,
            )
        except ValueError:
            return
        line = "L3:" + ";".join(f"{i}={mask}" for i in cache_ids)
        if self.fs.write_schemata_line(group, line):
            ctx.log("resctrl", group, "schemata", line)

    def _apply_mb(self, ctx, group, cache_ids, resctrl) -> None:
        value = calculate_mba(resctrl.mba_percent, self._vendor_for(ctx))
        line = "MB:" + ";".join(f"{i}={value}" for i in cache_ids)
        if self.fs.write_schemata_line(group, line):
            ctx.log("resctrl", group, "schemata", line)

    # -- task placement (:211-292) -----------------------------------------

    def _move_tasks(self, ctx: QoSContext) -> None:
        """Pull every pod's task ids into its QoS group's tasks file; ids
        come from the pod cgroup's cgroup.procs under the fake/real root."""
        for pod in ctx.pod_provider.running_pods():
            group = pod_resctrl_group(pod.qos)
            if not group:
                continue
            tids = self._pod_task_ids(ctx, pod)
            if tids:
                try:
                    self.fs.add_tasks(group, tids)
                except OSError:
                    # a task that exited mid-write (ESRCH) is retried on
                    # the next tick; don't abort the pass
                    continue

    def _pod_task_ids(self, ctx: QoSContext, pod) -> List[int]:
        """Thread-level task ids: the resctrl tasks file moves exactly the
        written TID, so worker threads must be moved individually — read
        the cgroup's thread-level files first (v1 ``tasks``, v2
        ``cgroup.threads``), falling back to ``cgroup.procs`` (leaders
        only) when absent."""
        tids: List[int] = []
        dirs = [pod.cgroup_dir] + list(pod.containers.values())
        root = ctx.system_config.cgroup_root
        if ctx.system_config.use_cgroup_v2:
            sub, names = "", ("cgroup.threads", "cgroup.procs")
        else:
            sub, names = "cpu", ("tasks", "cgroup.procs")
        for d in dirs:
            for name in names:
                path = os.path.join(root, sub, d, name)
                if not os.path.exists(path):
                    continue
                try:
                    with open(path) as f:
                        tids.extend(
                            int(x) for x in f.read().split() if x.strip()
                        )
                except (OSError, ValueError):
                    pass
                break  # thread-level file found: don't double-read procs
        return sorted(set(tids))
