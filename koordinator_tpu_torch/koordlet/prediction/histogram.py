"""Vectorized decaying exponential histograms (counterpart of
``koordinator_tpu/koordlet/prediction/histogram.py``: numpy, float64,
bit for bit the reference's).

Reference: pkg/koordlet/prediction/predict_server.go:205-222 — the
reference keeps one VPA-style decaying exponential histogram per subject
(pod/priority/node) per resource. The design: a *bank* holds every
subject's histogram as one ``[N, B]`` weight matrix over shared
exponential bucket boundaries, so decay is one elementwise multiply,
sample ingest is a row scatter-add, and percentiles for ALL subjects are
one cumulative-sum pass — the whole node's predictor state updates in a
few fused array ops instead of N object updates.

VPA bucket semantics: bucket 0 spans ``[0, first)``; bucket b >= 1 spans
``[first*growth^(b-1), first*growth^b)``, and percentile queries return
the crossing bucket's *start* (vpa histogram.Percentile). Growth 1.05
(DefaultHistogramBucketSizeGrowth 0.05), first bucket 25 mCPU for CPU /
5 MiB for memory (predict_server.go:208,217 scaled to canonical units).
Decay halves a sample's weight every half-life (cpu 12h, mem 24h,
config.go:40-42), applied lazily per row.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np


class HistogramBank:
    """N decaying histograms over shared exponential buckets."""

    def __init__(self, first_bucket: float, growth: float = 1.05,
                 num_buckets: int = 256, half_life_seconds: float = 12 * 3600):
        self.first_bucket = first_bucket
        self.growth = growth
        self.num_buckets = num_buckets
        self.half_life = half_life_seconds
        #: start of each bucket (VPA GetBucketStart): 0 for bucket 0,
        #: first*growth^(b-1) for b >= 1
        self.bounds = np.concatenate(
            [[0.0], first_bucket * growth ** np.arange(num_buckets - 1)]
        )
        self._rows: Dict[str, int] = {}
        self._weights = np.zeros((0, num_buckets), np.float64)
        self._last_decay = np.zeros(0, np.float64)
        self._first_seen: Dict[str, float] = {}

    # -- rows ---------------------------------------------------------------

    def _row(self, key: str, now: float) -> int:
        idx = self._rows.get(key)
        if idx is None:
            idx = len(self._rows)
            self._rows[key] = idx
            if idx >= self._weights.shape[0]:
                grow = max(16, self._weights.shape[0])
                self._weights = np.vstack(
                    [self._weights, np.zeros((grow, self.num_buckets))]
                )
                self._last_decay = np.concatenate(
                    [self._last_decay, np.zeros(grow)]
                )
            self._last_decay[idx] = now
            self._first_seen[key] = now
        return idx

    def first_seen(self, key: str) -> Optional[float]:
        return self._first_seen.get(key)

    def _bucket(self, value: float) -> int:
        if value < self.first_bucket:
            return 0
        b = (
            int(math.log(value / self.first_bucket) / math.log(self.growth))
            + 1
        )
        return min(b, self.num_buckets - 1)

    def _decay_row(self, idx: int, now: float) -> None:
        dt = now - self._last_decay[idx]
        if dt > 0:
            self._weights[idx] *= 0.5 ** (dt / self.half_life)
            self._last_decay[idx] = now

    # -- ingest -------------------------------------------------------------

    def add(self, key: str, value: float, now: float,
            weight: float = 1.0) -> None:
        idx = self._row(key, now)
        self._decay_row(idx, now)
        self._weights[idx, self._bucket(value)] += weight

    # -- query --------------------------------------------------------------

    def percentile(self, key: str, p: float) -> Optional[float]:
        got = self.percentiles_batch([key], [p])
        return got[0][0]

    def percentiles_batch(
        self, keys: Sequence[str], ps: Sequence[float]
    ) -> List[List[Optional[float]]]:
        """[K, P] percentile matrix in one cumsum pass (the bank-wide
        analogue of histogram.Percentile)."""
        idxs = [self._rows.get(k, -1) for k in keys]
        out: List[List[Optional[float]]] = []
        valid = [i for i in idxs if i >= 0]
        if valid:
            w = self._weights[valid]
            total = w.sum(axis=1)
            cum = np.cumsum(w, axis=1)
        pos = 0
        for i in idxs:
            if i < 0:
                out.append([None] * len(ps))
                continue
            t = total[pos]
            if t <= 0:
                out.append([None] * len(ps))
                pos += 1
                continue
            row = cum[pos]
            vals: List[Optional[float]] = []
            for p in ps:
                b = int(np.searchsorted(row, p * t, side="left"))
                b = min(b, self.num_buckets - 1)
                vals.append(float(self.bounds[b]))
            out.append(vals)
            pos += 1
        return out

    def forget(self, live_keys: Iterable[str]) -> None:
        """Drop rows for departed subjects (compaction)."""
        live = set(live_keys)
        dead = [k for k in self._rows if k not in live]
        if not dead:
            return
        keep = [k for k in self._rows if k in live]
        new_weights = np.zeros((max(len(keep), 16), self.num_buckets))
        new_decay = np.zeros(max(len(keep), 16))
        new_rows = {}
        for j, k in enumerate(keep):
            new_weights[j] = self._weights[self._rows[k]]
            new_decay[j] = self._last_decay[self._rows[k]]
            new_rows[k] = j
        for k in dead:
            self._first_seen.pop(k, None)
        self._rows = new_rows
        self._weights = new_weights
        self._last_decay = new_decay

    # -- checkpoint ---------------------------------------------------------

    #: checkpoint format version; bumped when bucket semantics change so
    #: stale checkpoints are discarded instead of silently reinterpreted
    STATE_VERSION = 2

    def state(self) -> dict:
        keys = list(self._rows)
        idxs = [self._rows[k] for k in keys]
        return {
            "version": self.STATE_VERSION,
            "keys": keys,
            "weights": self._weights[idxs].tolist(),
            "last_decay": self._last_decay[idxs].tolist(),
            "first_seen": [self._first_seen.get(k, 0.0) for k in keys],
        }

    def load_state(self, state: dict) -> None:
        if state.get("version") != self.STATE_VERSION:
            return  # stale format: cold-start rather than misread buckets
        keys = state["keys"]
        n = len(keys)
        self._rows = {k: i for i, k in enumerate(keys)}
        self._weights = np.array(state["weights"], np.float64).reshape(
            n, self.num_buckets
        ) if n else np.zeros((0, self.num_buckets))
        self._last_decay = np.array(state["last_decay"], np.float64)
        self._first_seen = dict(zip(keys, state["first_seen"]))
