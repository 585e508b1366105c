"""Performance (CPI) collector: cycles-per-instruction via the native
perf-group module.

Reference: pkg/koordlet/metricsadvisor/collectors/performance/
performance_collector_linux.go — per running container it opens a
cycles+instructions perf group on the container cgroup (one fd per cpu),
reads the deltas each tick, and appends a CPI sample. The native source
here is ``native/perf_group.cpp``; the collector takes a
source *factory* so hosts without perf (locked-down
perf_event_paranoid) or tests can inject the deterministic fake backend.

Counterpart of
``koordinator_tpu/koordlet/metricsadvisor/performance.py``: host work,
bit for bit the reference's.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

from koordinator_tpu_torch.koordlet.metriccache import MetricKind
from koordinator_tpu_torch.koordlet.metricsadvisor.framework import (
    CollectorContext,
)
from koordinator_tpu_torch.native import PerfGroup, PerfUnavailable

#: factory: (container cgroup dir) -> PerfGroup
SourceFactory = Callable[[str], PerfGroup]


def cgroup_perf_factory(ctx: CollectorContext) -> SourceFactory:
    """Real source: perf groups on the container's (v2) cgroup dir across
    all online cpus (the reference's per-container layout)."""

    def open_source(container_dir: str) -> PerfGroup:
        cfg = ctx.system_config
        if cfg.use_cgroup_v2:
            path = os.path.join(cfg.cgroup_root, container_dir)
        else:
            # v1: perf cgroups live under the perf_event hierarchy
            path = os.path.join(cfg.cgroup_root, "perf_event", container_dir)
        fd = os.open(path, os.O_RDONLY)
        try:
            return PerfGroup.open_cgroup(fd, range(os.cpu_count() or 1))
        finally:
            os.close(fd)

    return open_source


class PerformanceCollector:
    """Appends CONTAINER_CPI samples (cycles/instruction per interval)."""

    name = "performance"

    def __init__(self, source_factory: Optional[SourceFactory] = None):
        self.ctx: Optional[CollectorContext] = None
        self._factory = source_factory
        self._sources: Dict[str, PerfGroup] = {}
        self._last: Dict[str, Tuple[int, int]] = {}
        self._failed = False

    def setup(self, ctx: CollectorContext) -> None:
        self.ctx = ctx
        if self._factory is None:
            self._factory = cgroup_perf_factory(ctx)

    def enabled(self) -> bool:
        return (
            self.ctx is not None
            and self.ctx.pod_provider is not None
            and not self._failed
        )

    def collect(self, now: float) -> None:
        ctx = self.ctx
        live = set()
        for pod in ctx.pod_provider.running_pods():
            if self._failed:
                break
            for cname, cdir in pod.containers.items():
                key = f"{pod.uid}/{cname}"
                live.add(key)
                source = self._sources.get(key)
                if source is None:
                    try:
                        source = self._factory(cdir)
                    except PerfUnavailable:
                        # no perf on this host: disable the collector
                        # rather than retrying every tick
                        self._failed = True
                        break
                    except OSError:
                        # transient: the container's cgroup vanished
                        # between listing and open — skip it this tick
                        continue
                    self._sources[key] = source
                try:
                    cycles, instr = source.read()
                except PerfUnavailable:
                    # dead fds (cgroup torn down & recreated): drop the
                    # source so the next tick reopens it fresh
                    self._sources.pop(key, None)
                    self._last.pop(key, None)
                    source.close()
                    continue
                prev = self._last.get(key)
                self._last[key] = (cycles, instr)
                if prev is None:
                    continue  # primer tick: no delta yet
                d_cycles = cycles - prev[0]
                d_instr = instr - prev[1]
                if d_instr <= 0:
                    continue
                ctx.metric_cache.append(
                    MetricKind.CONTAINER_CPI,
                    {"pod": pod.uid, "container": cname},
                    now,
                    d_cycles / d_instr,
                )
        # drop sources of containers that went away
        for key in list(self._sources):
            if key not in live:
                self._sources.pop(key).close()
                self._last.pop(key, None)
