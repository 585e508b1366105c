"""Placement explainability: per-node, per-column score breakdowns for one
pod (counterpart of ``koordinator_tpu/obs/explain.py``).

The batched solve answers "where does the whole queue go" in one launch;
when an operator asks "why did pod X land on node Y" or "why is pod X
unschedulable", its argmax is opaque. This module runs a breakdown off
the hot path: the filter and score primitives the solve composes
(``ops/fit.py``, ``ops/loadaware.py``, torch ops on the model's device),
evaluated for one pod against the whole node set, every column kept:

- filter verdicts: ``schedulable``, ``fit_feasible``,
  ``loadaware_feasible`` (and the host-side ``selector`` row);
- score columns: ``fit_score`` (NodeResourcesFit, LeastAllocated) and
  ``loadaware_score`` (LoadAwareScheduling), each unweighted, exactly what
  the plugin chain's per-plugin ``score`` returns, and the
  ``weighted_total`` the argmax ranks by.

Each column equals the oracle's scalar function (``fit_filter_node``,
``loadaware_filter_node``, ``least_allocated_score_node``,
``loadaware_score_node``) on the same lowered arrays: a breakdown that
disagrees with a placement is a bug. The port's integer division is
exact, so the reference's ``reciprocal_for`` has no counterpart.

``explain_scores`` reads the columns back once, on debug-mux demand,
never inside the solve loop.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from koordinator_tpu_torch.apis.types import selector_matches
from koordinator_tpu_torch.ops.fit import fit_filter, least_allocated_score
from koordinator_tpu_torch.ops.loadaware import (
    loadaware_filter,
    loadaware_score,
)
from koordinator_tpu_torch.state.cluster import (
    NodeArrays,
    lower_nodes,
    lower_pending_pods,
)

#: the breakdown's columns, in read-back order; the first three are masks
COLUMNS = ("schedulable", "fit_feasible", "loadaware_feasible",
           "fit_score", "loadaware_score", "weighted_total")
_MASKS = 3


def _breakdown(state, req, est, is_prod, is_ds, params, config
               ) -> Dict[str, torch.Tensor]:
    """Per-column (never argmax-fused) single-pod scoring: the primitives
    the solve's per-pod step composes, returned unreduced."""
    fit_ok = fit_filter(req, state.alloc, state.used_req)
    load_ok = loadaware_filter(
        state.alloc, state.usage, state.prod_usage, state.metric_fresh,
        params.thresholds, params.prod_thresholds, is_ds, is_prod)
    fit_sc = least_allocated_score(req, state.alloc, state.used_req,
                                   params.weights)
    load_sc = loadaware_score(
        est, state.alloc, state.usage, state.est_extra, state.prod_base,
        state.metric_fresh, params.weights, is_prod,
        config.score_according_prod)
    total = config.fit_weight * fit_sc + config.loadaware_weight * load_sc
    return {
        "schedulable": state.schedulable,
        "fit_feasible": fit_ok,
        "loadaware_feasible": load_ok,
        "fit_score": fit_sc,
        "loadaware_score": load_sc,
        "weighted_total": total,
    }


def explain_scores(model, snapshot, pod
                   ) -> Tuple[NodeArrays, Dict[str, np.ndarray]]:
    """``(lowered NodeArrays, {column: host array})`` for one pod against
    the snapshot's whole node set, lowered with the model's lowering
    kwargs and staged through ``model.stage_nodes``, scored with its
    params and config: as a solve would. One read-back of the stacked
    columns, trimmed to the real node count."""
    arrays = lower_nodes(snapshot, **model.lowering_kwargs())
    pods = lower_pending_pods([pod], scaling_factors=model.scaling_factors,
                              resource_weights=model.resource_weights)
    state = model.stage_nodes(arrays)
    device = state.alloc.device

    def put(a):
        return torch.as_tensor(np.asarray(a), device=device)

    out = _breakdown(state, put(pods.req[0]), put(pods.est[0]),
                     put(bool(pods.is_prod[0])),
                     put(bool(pods.is_daemonset[0])), model.params,
                     model.config)
    stacked = torch.stack([out[name].to(torch.int32) for name in COLUMNS])
    host = stacked.cpu().numpy()[:, : arrays.n]
    cols = {name: (host[k].astype(bool) if k < _MASKS else host[k])
            for k, name in enumerate(COLUMNS)}
    return arrays, cols


class PlacementExplainer:
    """The debug mux's front end over :func:`explain_scores` for a wired
    Scheduler: the device columns plus the host-side verdicts the batched
    round enforces (node selector, quota admission, gang blocking,
    reservation matches), recorded into the scheduler's
    ``DebugRecorder``."""

    #: nodes listed in full detail per payload (the rest summarised)
    TOP_K = 10

    def __init__(self, scheduler):
        self.scheduler = scheduler

    def explain(self, pod_uid: str, node: Optional[str] = None,
                now: Optional[float] = None) -> dict:
        sched = self.scheduler
        pod = sched.cache.pending.get(pod_uid) or sched.cache.pods.get(pod_uid)
        if pod is None:
            return {"error": f"unknown pod {pod_uid!r}"}
        snapshot = sched.cache.snapshot(now=now)
        arrays, cols = explain_scores(sched.model, snapshot, pod)
        n = arrays.n
        names = list(arrays.names)
        mask = (cols["schedulable"] & cols["fit_feasible"]
                & cols["loadaware_feasible"])
        selector_row = None
        if pod.node_selector:
            selector_row = np.fromiter(
                (selector_matches(pod.node_selector, nd.labels)
                 for nd in snapshot.nodes),
                dtype=bool, count=n)
            mask = mask & selector_row

        verdicts: Dict[str, object] = {}
        if pod.gang:
            verdicts["gang_known"] = pod.gang in snapshot.gangs
        if pod.quota:
            from koordinator_tpu_torch.scheduler.framework import CycleState

            status = sched._quota_plugin.pre_filter(
                CycleState(sched.framework.cycle_seed), snapshot, pod)
            verdicts["quota_admitted"] = status.ok
            if not status.ok:
                verdicts["quota_reason"] = status.reason
        if snapshot.reservations:
            from koordinator_tpu_torch.scheduler.plugins.reservation import (
                reservation_matches_pod,
            )

            verdicts["reservation_matches"] = [
                r.name for r in snapshot.reservations
                if reservation_matches_pod(r, pod)]

        total = cols["weighted_total"]
        ranked = np.where(mask, total, -1)
        best = int(np.argmax(ranked)) if n else -1
        winner = names[best] if n and ranked[best] >= 0 else None

        def node_detail(i: int) -> dict:
            d = {
                "node": names[i],
                "feasible": bool(mask[i]),
                "filters": {
                    "schedulable": bool(cols["schedulable"][i]),
                    "fit": bool(cols["fit_feasible"][i]),
                    "loadaware": bool(cols["loadaware_feasible"][i]),
                },
                "scores": {
                    "NodeResourcesFit": int(cols["fit_score"][i]),
                    "LoadAwareScheduling": int(cols["loadaware_score"][i]),
                    "weighted_total": int(total[i]),
                },
            }
            if selector_row is not None:
                d["filters"]["selector"] = bool(selector_row[i])
            return d

        order = np.argsort(-ranked, kind="stable")[: self.TOP_K]
        payload = {
            "pod": pod_uid,
            "assigned": pod.node_name,
            "winner": winner,
            "node_count": n,
            "feasible_count": int(mask.sum()),
            "filter_rejections": {
                "unschedulable": int((~cols["schedulable"]).sum()),
                "fit": int((~cols["fit_feasible"]).sum()),
                "loadaware": int((~cols["loadaware_feasible"]).sum()),
                **({"selector": int((~selector_row).sum())}
                   if selector_row is not None else {}),
            },
            "verdicts": verdicts,
            "top_nodes": [node_detail(int(i)) for i in order],
        }
        if node is not None:
            if node in names:
                payload["queried_node"] = node_detail(names.index(node))
            else:
                payload["queried_node"] = {"error": f"unknown node {node!r}"}
        sched.debug.record_explain(payload)
        return payload
