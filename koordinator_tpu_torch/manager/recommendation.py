"""Recommendation controller: observed usage → right-sized requests.

The port's copy of ``koordinator_tpu/manager/recommendation.py``, equal to it bit for
bit (held by ``tests/test_torch_*.py`` on the same inputs).

Reference: the analysis.koordinator.sh API group
(apis/analysis/v1alpha1/recommendation_types.go:55) defines the object;
the usage statistics the status is computed from are exactly what the
koordlet prediction subsystem already maintains
(pkg/koordlet/prediction/peak_predictor.go: decaying histograms, p95 cpu
/ p98 memory peaks with a safety margin). This controller reuses that
machinery (:class:`PeakPredictServer`) at the cluster level:

- **observe**: fold every fresh NodeMetric's per-pod usage samples into
  one histogram bank per Recommendation target (workload owner-ref or
  pod label selector);
- **reconcile**: publish each Recommendation's peak estimate as its
  status on the bus;
- **consume**: :func:`wire_recommendation` keeps a PodMutatingWebhook's
  right-sizer pointed at the live Recommendation index, so admitted pods
  of a covered workload get their requests re-sized from observed usage
  (the VPA-shaped loop the reference's Recommendation API exists for).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from koordinator_tpu_torch.apis.analysis import (
    CONDITION_NO_SAMPLES,
    CONDITION_READY,
    Recommendation,
)
from koordinator_tpu_torch.apis.extension import ResourceName
from koordinator_tpu_torch.apis.types import PodSpec, Resources
from koordinator_tpu_torch.client.bus import APIServer, EventType, Kind
from koordinator_tpu_torch.koordlet.prediction.predict_server import (
    PeakPredictServer,
    PredictionConfig,
)


class RecommendationController:
    """Cluster-level analysis over the bus (koord-manager component)."""

    def __init__(self, bus: APIServer,
                 config: Optional[PredictionConfig] = None, elector=None):
        self.bus = bus
        # one decaying-histogram bank, keyed by recommendation name —
        # the same estimator koordlet's predictor uses per pod
        self.server = PeakPredictServer(config)
        #: node -> update_time of the last NodeMetric folded in (samples
        #: are per report; re-reading an unchanged metric adds nothing)
        self._seen: Dict[str, float] = {}
        #: leader-elected deployments fence status writes — a deposed
        #: manager must not overwrite the leader's published numbers
        self.elector = elector

    # -- ingest --------------------------------------------------------------

    def observe(self, now: float) -> int:
        """Fold fresh NodeMetric pod samples into the target histograms;
        returns how many (pod, recommendation) samples were added."""
        recs = list(self.bus.list(Kind.RECOMMENDATION).values())
        if not recs:
            return 0
        pods = {p.uid: p for p in self.bus.list(Kind.POD).values()}
        added = 0
        for metric in self.bus.list(Kind.NODE_METRIC).values():
            if metric.update_time <= self._seen.get(metric.node_name, 0.0):
                continue
            self._seen[metric.node_name] = metric.update_time
            for uid, usage in metric.pod_usages.items():
                pod = pods.get(uid)
                if pod is None:
                    continue
                for rec in recs:
                    if not rec.target.matches(pod):
                        continue
                    self.server.update(
                        rec.name,
                        float(usage.get(ResourceName.CPU, 0)),
                        float(usage.get(ResourceName.MEMORY, 0)),
                        now,
                    )
                    added += 1
        return added

    # -- publish -------------------------------------------------------------

    def _publish(self, name: str, rec) -> None:
        if self.elector is not None:
            self.elector.fenced(
                lambda: self.bus.apply(Kind.RECOMMENDATION, name, rec)
            )
        else:
            self.bus.apply(Kind.RECOMMENDATION, name, rec)

    def reconcile(self, now: float) -> int:
        """Recompute every Recommendation's status and publish changed
        ones on the bus; returns how many were updated."""
        updated = 0
        for name, rec in self.bus.list(Kind.RECOMMENDATION).items():
            peak = self.server.peak(rec.name)
            if peak["cpu"] is None and peak["memory"] is None:
                # an empty LOCAL bank must not clobber a ready status a
                # previous leader published (post-failover warm-up) —
                # only never-computed recs get the NoSamples condition
                if rec.ready:
                    continue
                if not rec.conditions.get(CONDITION_NO_SAMPLES):
                    # publish a COPY: a fenced-off (deposed) write must
                    # leak nothing into the shared bus object
                    self._publish(name, dataclasses.replace(
                        rec,
                        conditions={CONDITION_NO_SAMPLES: True,
                                    CONDITION_READY: False},
                        update_time=now,
                    ))
                    updated += 1
                continue
            recommended: Resources = {}
            if peak["cpu"] is not None:
                recommended[ResourceName.CPU] = int(math.ceil(peak["cpu"]))
            if peak["memory"] is not None:
                recommended[ResourceName.MEMORY] = int(
                    math.ceil(peak["memory"])
                )
            # publish on value change OR when not yet consumable (a
            # pre-seeded recommended value without conditions must still
            # gain the Ready condition)
            if recommended != rec.recommended or not rec.ready:
                self._publish(name, dataclasses.replace(
                    rec,
                    recommended=recommended,
                    conditions={CONDITION_READY: True,
                                CONDITION_NO_SAMPLES: False},
                    update_time=now,
                ))
                updated += 1
        return updated

    def run_once(self, now: float) -> int:
        self.observe(now)
        return self.reconcile(now)


class RecommendationIndex:
    """Live read side: resolves a pod to its covering Recommendation
    (what the webhook right-sizer consumes)."""

    def __init__(self):
        self._recs: Dict[str, Recommendation] = {}

    def on_event(self, event: EventType, name: str, rec) -> None:
        if event is EventType.DELETED:
            self._recs.pop(name, None)
        else:
            self._recs[name] = rec

    def recommendation_for(self, pod: PodSpec) -> Optional[Resources]:
        for name in sorted(self._recs):
            rec = self._recs[name]
            if rec.ready and rec.target.matches(pod):
                return dict(rec.recommended)
        return None


def wire_recommendation(bus: APIServer, webhook=None,
                        config: Optional[PredictionConfig] = None,
                        elector=None):
    """Build the controller and (optionally) point a PodMutatingWebhook's
    right-sizer at the live index; returns the controller."""
    controller = RecommendationController(bus, config, elector)
    index = RecommendationIndex()
    bus.watch(Kind.RECOMMENDATION, index.on_event)
    if webhook is not None:
        webhook.recommendation_for = index.recommendation_for
    return controller
