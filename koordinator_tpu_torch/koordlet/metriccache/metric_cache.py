"""In-memory time-series store for node/pod/container metrics.

Reference: pkg/koordlet/metriccache/ — the reference embeds a Prometheus
TSDB (tsdb_storage.go) plus an in-memory KV (kv_storage.go) and exposes
typed metric resources with aggregate queries (avg/p50/p90/p95/p99/last/
count, metric_result.go:75-175).

The design: series are fixed-capacity numpy ring buffers (no
external TSDB dependency, no disk); aggregation is vectorized — a batch
query stacks every requested series into one [S, T] matrix and reduces
along time in one shot (sort for the percentile family), which is the
shape the NodeMetric reporter wants (all pods aggregated at once).

Values are float64 in canonical units (mCPU / MiB) so downstream
consumers round into the int32 arrays the solver lowers.

Aggregation semantics match the reference exactly
(util.go:55-100): percentile = ascending sort, index
``max(int(n*p) - 1, 0)``; avg = arithmetic mean; last = latest by
timestamp; count = number of points.

Counterpart of ``koordinator_tpu/koordlet/metriccache/metric_cache.py``:
host work in numpy and files, bit for bit the reference's.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np


class MetricKind(str, enum.Enum):
    """Typed metric resources (reference: metric_resources.go)."""

    NODE_CPU_USAGE = "node_cpu_usage"            # mCPU
    NODE_MEMORY_USAGE = "node_memory_usage"      # MiB
    POD_CPU_USAGE = "pod_cpu_usage"              # mCPU, label pod=<uid>
    POD_MEMORY_USAGE = "pod_memory_usage"        # MiB, label pod=<uid>
    CONTAINER_CPU_USAGE = "container_cpu_usage"  # mCPU, label container=
    CONTAINER_MEMORY_USAGE = "container_memory_usage"
    BE_CPU_USAGE = "be_cpu_usage"                # mCPU (all BE pods)
    SYS_CPU_USAGE = "sys_cpu_usage"              # mCPU (node - pods)
    SYS_MEMORY_USAGE = "sys_memory_usage"        # MiB
    PSI_CPU_SOME_AVG10 = "psi_cpu_some_avg10"    # percent
    PSI_MEM_SOME_AVG10 = "psi_mem_some_avg10"
    PSI_MEM_FULL_AVG10 = "psi_mem_full_avg10"
    PSI_IO_SOME_AVG10 = "psi_io_some_avg10"
    CONTAINER_CPI = "container_cpi"              # cycles/instruction
    HOST_APP_CPU_USAGE = "host_app_cpu_usage"    # mCPU, label app=
    HOST_APP_MEMORY_USAGE = "host_app_memory_usage"
    NODE_COLD_PAGE_BYTES = "node_cold_page_bytes"    # kidled cold file pages
    NODE_PAGE_CACHE_MIB = "node_page_cache_mib"      # meminfo Cached
    DEVICE_UTIL = "device_util"                  # percent, label minor=
    DEVICE_MEMORY_USED = "device_memory_used"    # MiB, label minor=
    POD_CPU_THROTTLED_RATIO = "pod_cpu_throttled_ratio"  # 0..1, label pod=
    NODE_DISK_READ_BPS = "node_disk_read_bps"    # bytes/s, label dev=
    NODE_DISK_WRITE_BPS = "node_disk_write_bps"  # bytes/s, label dev=
    NODE_DISK_IO_UTIL = "node_disk_io_util"      # percent, label dev=


class AggregationType(str, enum.Enum):
    AVG = "avg"
    P99 = "p99"
    P95 = "p95"
    P90 = "p90"
    P50 = "p50"
    LAST = "last"
    COUNT = "count"


_PERCENTILE = {
    AggregationType.P99: 0.99,
    AggregationType.P95: 0.95,
    AggregationType.P90: 0.90,
    AggregationType.P50: 0.50,
}

#: series key: (kind, sorted label items)
SeriesKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(kind: MetricKind, labels: Optional[Mapping[str, str]]) -> SeriesKey:
    return (kind.value, tuple(sorted((labels or {}).items())))


class _Ring:
    """Fixed-capacity (time, value) ring buffer."""

    __slots__ = ("ts", "vals", "head", "size")

    def __init__(self, capacity: int):
        self.ts = np.zeros(capacity, np.float64)
        self.vals = np.zeros(capacity, np.float64)
        self.head = 0  # next write slot
        self.size = 0

    def append(self, t: float, v: float) -> None:
        cap = len(self.ts)
        self.ts[self.head] = t
        self.vals[self.head] = v
        self.head = (self.head + 1) % cap
        self.size = min(self.size + 1, cap)

    def window(self, start: float, end: float) -> Tuple[np.ndarray, np.ndarray]:
        """Chronological points with start <= t <= end."""
        cap = len(self.ts)
        if self.size < cap:
            ts, vals = self.ts[: self.size], self.vals[: self.size]
        else:
            idx = np.arange(self.head, self.head + cap) % cap
            ts, vals = self.ts[idx], self.vals[idx]
        mask = (ts >= start) & (ts <= end)
        return ts[mask], vals[mask]


def aggregate_points(
    vals: np.ndarray, agg: AggregationType
) -> Optional[float]:
    """Reference semantics (util.go): None on empty input."""
    n = len(vals)
    if n == 0:
        return None
    if agg is AggregationType.COUNT:
        return float(n)
    if agg is AggregationType.LAST:
        return float(vals[-1])
    if agg is AggregationType.AVG:
        return float(vals.mean())
    p = _PERCENTILE[agg]
    idx = max(int(n * p) - 1, 0)
    return float(np.sort(vals)[idx])


class MetricCache:
    """Typed series store + KV (reference: metric_cache.go:56)."""

    def __init__(self, capacity_per_series: int = 4096,
                 retention_seconds: float = 30 * 60):
        self._capacity = capacity_per_series
        self._series: Dict[SeriesKey, _Ring] = {}
        self._kv: Dict[str, object] = {}
        self.retention_seconds = retention_seconds

    # -- KV (reference: kv_storage.go) --------------------------------------

    def set(self, key: str, value: object) -> None:
        self._kv[key] = value

    def get(self, key: str) -> Optional[object]:
        return self._kv.get(key)

    # -- time series --------------------------------------------------------

    def append(self, kind: MetricKind, labels: Optional[Mapping[str, str]],
               timestamp: float, value: float) -> None:
        key = _key(kind, labels)
        ring = self._series.get(key)
        if ring is None:
            ring = self._series[key] = _Ring(self._capacity)
        ring.append(timestamp, float(value))

    def query(self, kind: MetricKind,
              labels: Optional[Mapping[str, str]] = None,
              start: float = -math.inf,
              end: float = math.inf) -> Tuple[np.ndarray, np.ndarray]:
        ring = self._series.get(_key(kind, labels))
        if ring is None:
            return np.zeros(0), np.zeros(0)
        return ring.window(start, end)

    def label_values(self, kind: MetricKind, label: str) -> List[str]:
        """Distinct values of one label across a kind's series (e.g. the
        block devices the storage collector has reported)."""
        out = set()
        for key_kind, labels in self._series:
            if key_kind != kind.value:
                continue
            for name, value in labels:
                if name == label:
                    out.add(value)
        return sorted(out)

    def aggregate(self, kind: MetricKind,
                  labels: Optional[Mapping[str, str]] = None,
                  start: float = -math.inf, end: float = math.inf,
                  agg: AggregationType = AggregationType.AVG
                  ) -> Optional[float]:
        _, vals = self.query(kind, labels, start, end)
        return aggregate_points(vals, agg)

    # -- persistence (reference: the TSDB lives on disk,
    # metriccache/tsdb_storage.go — a koordlet restart keeps its
    # aggregation window instead of reporting from empty) -------------------

    def save(self, path: str) -> None:
        """Atomic npz snapshot of every series (chronological points)."""
        import json
        import math as _math
        import os

        arrays = {}
        meta = []
        for i, (key, ring) in enumerate(self._series.items()):
            ts, vals = ring.window(-_math.inf, _math.inf)
            arrays[f"ts_{i}"] = ts
            arrays[f"v_{i}"] = vals
            meta.append(list(key))
        arrays["meta"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)

    def load(self, path: str) -> bool:
        """Restore a snapshot; returns False if absent/corrupt."""
        import json
        import os

        if not os.path.exists(path):
            return False
        # restore into a LOCAL dict and commit only on full success: a
        # corrupt snapshot (zipfile.BadZipFile, truncated arrays, missing
        # keys — anything) must leave the cache untouched, not
        # half-populated
        restored: Dict[SeriesKey, _Ring] = {}
        try:
            with np.load(path) as data:
                meta = json.loads(bytes(data["meta"]).decode())
                for i, key in enumerate(meta):
                    kind, labels = key
                    ring = _Ring(self._capacity)
                    ts, vals = data[f"ts_{i}"], data[f"v_{i}"]
                    order = np.argsort(ts, kind="stable")
                    for t, v in zip(ts[order], vals[order]):
                        ring.append(float(t), float(v))
                    restored[
                        (kind, tuple(tuple(kv) for kv in labels))
                    ] = ring
        except Exception:
            return False
        self._series.update(restored)
        return True

    def aggregate_batch(
        self,
        requests: Sequence[Tuple[MetricKind, Optional[Mapping[str, str]]]],
        start: float, end: float,
        aggs: Sequence[AggregationType],
    ) -> List[Dict[AggregationType, Optional[float]]]:
        """Aggregate many series x many types in one vectorized pass.

        The NodeMetric reporter calls this with every pod's cpu+memory
        series; windows are stacked into a padded [S, T] matrix and each
        reduction runs matrix-at-once instead of per-series loops
        (the batched analogue of states_nodemetric.go:332 collectMetric).
        """
        windows = [self.query(kind, labels, start, end)[1]
                   for kind, labels in requests]
        s = len(windows)
        if s == 0:
            return []
        maxt = max((len(w) for w in windows), default=0)
        out: List[Dict[AggregationType, Optional[float]]] = [
            {} for _ in range(s)
        ]
        if maxt == 0:
            for d in out:
                for a in aggs:
                    d[a] = None
            return out
        mat = np.full((s, maxt), np.nan)
        for i, w in enumerate(windows):
            mat[i, : len(w)] = w
        counts = np.sum(~np.isnan(mat), axis=1)
        # O(S*T log T) sort only when a percentile was actually requested
        sorted_mat = (
            np.sort(mat, axis=1)  # NaNs sort to the end
            if any(a in _PERCENTILE for a in aggs) else None
        )
        for a in aggs:
            if a is AggregationType.COUNT:
                vals = counts.astype(float)
            elif a is AggregationType.AVG:
                vals = np.nansum(mat, axis=1) / np.maximum(counts, 1)
            elif a is AggregationType.LAST:
                last_idx = np.maximum(counts - 1, 0)
                vals = mat[np.arange(s), last_idx]
            else:
                p = _PERCENTILE[a]
                idx = np.maximum((counts * p).astype(int) - 1, 0)
                vals = sorted_mat[np.arange(s), idx]
            for i in range(s):
                out[i][a] = float(vals[i]) if counts[i] > 0 else None
        return out

    def gc(self, now: float) -> int:
        """Drop series with no point in the retention window (reference:
        tsdb head GC / recycleDB)."""
        dead = [
            k for k, ring in self._series.items()
            if ring.size == 0
            or ring.window(now - self.retention_seconds, math.inf)[0].size == 0
        ]
        for k in dead:
            del self._series[k]
        return len(dead)
