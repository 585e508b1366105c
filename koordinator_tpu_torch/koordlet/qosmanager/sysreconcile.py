"""SystemConfig reconcile: node-level /proc/sys memory knobs.

Reference: pkg/koordlet/qosmanager/plugins/sysreconcile/system_config.go
(:71-140): from the NodeSLO SystemStrategy,

    min_free_kbytes        = total_mem_kbytes * minFreeKbytesFactor / 10000
    watermark_scale_factor = strategy value (valid range 10..400)
    memcg reap background  = 0/1

written under /proc/sys/vm (path-redirected through SystemConfig for
fake trees), with last-written caching so steady state costs no I/O.

Counterpart of ``koordinator_tpu/koordlet/qosmanager/sysreconcile.py``:
host work in files, bit for bit the reference's.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from koordinator_tpu_torch.koordlet.qosmanager.framework import QoSContext

#: valid ranges (reference: sysutil.MinFreeKbytes/WatermarkScaleFactor
#: validators)
MIN_FREE_KBYTES_RANGE = (10 * 1024, 400 * 1024 * 1024)
WATERMARK_SCALE_RANGE = (10, 400)


class SystemConfigReconcile:
    name = "sysreconcile"
    interval_seconds = 10.0

    def __init__(self):
        self._written: Dict[str, str] = {}

    def enabled(self, ctx: QoSContext) -> bool:
        return ctx.node_slo.system_strategy is not None

    def _vm_path(self, ctx: QoSContext, name: str) -> str:
        return os.path.join(ctx.system_config.proc_root, "sys", "vm", name)

    def _write(self, ctx: QoSContext, name: str, value: int) -> None:
        path = self._vm_path(ctx, name)
        text = str(int(value))
        if self._written.get(path) == text:
            return
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write(text)
        except OSError:
            return
        self._written[path] = text
        ctx.log("sysreconcile", name, "update", text)

    def execute(self, ctx: QoSContext, now: float) -> None:
        strategy = ctx.node_slo.system_strategy
        total_kbytes = ctx.node_capacity_mem_mib * 1024
        if strategy.min_free_kbytes_factor and total_kbytes > 0:
            value = total_kbytes * strategy.min_free_kbytes_factor // 10000
            if MIN_FREE_KBYTES_RANGE[0] <= value <= MIN_FREE_KBYTES_RANGE[1]:
                self._write(ctx, "min_free_kbytes", value)
        wsf = strategy.watermark_scale_factor
        if wsf and WATERMARK_SCALE_RANGE[0] <= wsf <= WATERMARK_SCALE_RANGE[1]:
            self._write(ctx, "watermark_scale_factor", wsf)
        if strategy.memcg_reap_background in (0, 1):
            self._write(
                ctx, "memcg_reap_background", strategy.memcg_reap_background
            )
