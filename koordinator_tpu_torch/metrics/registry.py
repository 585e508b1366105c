"""Minimal prometheus-compatible metric primitives (a copy of
``koordinator_tpu/metrics/registry.py``).

Counter / Gauge / Histogram with label sets, a Registry that gathers them
into the text exposition format, and a MergedGatherer combining several
registries (reference: component-base prometheus wrappers +
pkg/util/metrics/merged_gather.go).
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

LabelValues = Tuple[str, ...]


def _label_str(names: Sequence[str], values: LabelValues) -> str:
    if not names:
        return ""
    inner = ",".join(
        f'{n}="{v}"' for n, v in zip(names, values)
    )
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str = "",
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help_text = help_text
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()

    def _key(self, labels: Optional[Mapping[str, str]]) -> LabelValues:
        labels = labels or {}
        extra = set(labels) - set(self.label_names)
        missing = set(self.label_names) - set(labels)
        if extra or missing:
            raise ValueError(
                f"{self.name}: labels mismatch (extra={sorted(extra)}, "
                f"missing={sorted(missing)})"
            )
        return tuple(str(labels[n]) for n in self.label_names)

    def samples(self) -> Iterable[Tuple[str, str, float]]:
        """(name, label string, value) triples."""
        raise NotImplementedError

    def expose(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {self.help_text}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for name, label_str, value in self.samples():
            v = int(value) if float(value).is_integer() else value
            lines.append(f"{name}{label_str} {v}")
        return lines


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_text="", label_names=()):
        super().__init__(name, help_text, label_names)
        self._values: Dict[LabelValues, float] = {}

    def inc(self, labels: Optional[Mapping[str, str]] = None,
            amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, labels: Optional[Mapping[str, str]] = None) -> float:
        return self._values.get(self._key(labels), 0.0)

    def samples(self):
        for key, value in sorted(self._values.items()):
            yield self.name, _label_str(self.label_names, key), value


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_text="", label_names=()):
        super().__init__(name, help_text, label_names)
        self._values: Dict[LabelValues, float] = {}

    def set(self, value: float,
            labels: Optional[Mapping[str, str]] = None) -> None:
        with self._lock:
            self._values[self._key(labels)] = float(value)

    def add(self, amount: float,
            labels: Optional[Mapping[str, str]] = None) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, labels: Optional[Mapping[str, str]] = None) -> float:
        return self._values.get(self._key(labels), 0.0)

    def samples(self):
        for key, value in sorted(self._values.items()):
            yield self.name, _label_str(self.label_names, key), value


#: default duration buckets (prometheus DefBuckets)
DEF_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_text="", label_names=(),
                 buckets: Sequence[float] = DEF_BUCKETS):
        super().__init__(name, help_text, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[LabelValues, List[int]] = {}
        self._sums: Dict[LabelValues, float] = {}
        self._totals: Dict[LabelValues, int] = {}

    def observe(self, value: float,
                labels: Optional[Mapping[str, str]] = None) -> None:
        key = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            i = bisect.bisect_left(self.buckets, value)
            if i < len(counts):
                counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def count(self, labels: Optional[Mapping[str, str]] = None) -> int:
        return self._totals.get(self._key(labels), 0)

    def sum(self, labels: Optional[Mapping[str, str]] = None) -> float:
        return self._sums.get(self._key(labels), 0.0)

    def samples(self):
        for key in sorted(self._totals):
            cumulative = 0
            for bound, count in zip(self.buckets, self._counts[key]):
                cumulative += count
                labels = _label_str(
                    self.label_names + ("le",), key + (str(bound),)
                )
                yield f"{self.name}_bucket", labels, cumulative
            inf_labels = _label_str(self.label_names + ("le",), key + ("+Inf",))
            yield f"{self.name}_bucket", inf_labels, self._totals[key]
            base = _label_str(self.label_names, key)
            yield f"{self.name}_sum", base, self._sums[key]
            yield f"{self.name}_count", base, self._totals[key]


class Registry:
    """A named collection of metrics (prometheus.Registry)."""

    def __init__(self, name: str = ""):
        self.name = name
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> _Metric:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"duplicate metric {metric.name}")
            self._metrics[metric.name] = metric
        return metric

    def counter(self, name, help_text="", label_names=()) -> Counter:
        return self.register(Counter(name, help_text, label_names))

    def gauge(self, name, help_text="", label_names=()) -> Gauge:
        return self.register(Gauge(name, help_text, label_names))

    def histogram(self, name, help_text="", label_names=(),
                  buckets=DEF_BUCKETS) -> Histogram:
        return self.register(Histogram(name, help_text, label_names, buckets))

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def gather(self) -> str:
        """Text exposition of every registered metric."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            lines.extend(self._metrics[name].expose())
        return "\n".join(lines) + ("\n" if lines else "")


class MergedGatherer:
    """Gathers several registries as one endpoint (merged_gather.go —
    koordlet serves internal + external sets together)."""

    def __init__(self, registries: Sequence[Registry]):
        self.registries = list(registries)

    def gather(self) -> str:
        return "".join(r.gather() for r in self.registries)
