"""Seeded worlds for the plugin chain and the LoadAware aggregated
(percentile) mode, as plain data or on the port's types.

- :func:`aggregated_fields`: one node's seeded percentiles around its
  average usage, p50 <= p90 <= p95 <= p99, in the two windows the
  koordlet's NodeMetric reporter publishes by default
  (``koordlet/statesinformer/nodemetric_reporter.py:94-131``): the
  primary 300 s window (``aggregated_usage`` at ``aggregated_duration``)
  and an extra 1,800 s window (``aggregated_windows``).
- :func:`add_aggregated_usage`: those fields on every metric of a typed
  snapshot (the churn world of ``chip_smoke.py`` phase 17).
- :func:`chain_world_spec`: the world the batched round and the plugin
  chain are held equal on (500 nodes, the node count of bench config
  #18, 256 pending pods in quota groups, 16 label-owned reservations, no
  gangs), as plain data for ``testing.build_snapshot`` with either
  package's types.

Everything draws from ``numpy.random.default_rng(seed)``; no file is
read.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from koordinator_tpu_torch.apis.extension import ResourceName

PRIMARY_WINDOW_S = 300.0
EXTRA_WINDOW_S = 1800.0
PERCENTILES = (50, 90, 95, 99)
_CPU, _MEM = int(ResourceName.CPU), int(ResourceName.MEMORY)


def _percentiles(rng, usage: Dict[int, int]) -> Dict[int, Dict[int, int]]:
    """``{pct: {resource: value}}`` around ``usage`` (the average):
    p50 at 70-100% of it, then each higher percentile at or above the
    one below (p90 110-150% of the average)."""
    out: Dict[int, Dict[int, int]] = {pct: {} for pct in PERCENTILES}
    for r, avg in sorted(usage.items()):
        p50 = int(avg * rng.uniform(0.7, 1.0))
        p90 = max(p50, int(avg * rng.uniform(1.1, 1.5)))
        p95 = int(p90 * rng.uniform(1.0, 1.15))
        p99 = int(p95 * rng.uniform(1.0, 1.3))
        for pct, v in zip(PERCENTILES, (p50, p90, p95, p99)):
            out[pct][r] = v
    return out


def aggregated_fields(rng, usage: Dict[int, int]) -> dict:
    """The aggregated ``NodeMetric`` fields for one node as plain data
    (resources as ints): the primary window's percentiles, its duration,
    and the extra window's percentiles."""
    return dict(
        aggregated_usage=_percentiles(rng, usage),
        aggregated_duration=PRIMARY_WINDOW_S,
        aggregated_windows={EXTRA_WINDOW_S: _percentiles(rng, usage)},
    )


def typed_aggregated(fields: dict, resource_name=ResourceName) -> dict:
    """:func:`aggregated_fields` with ``resource_name`` keys (either
    package's ``ResourceName``), ready for ``NodeMetric(**...)``."""
    def by_pct(d):
        return {pct: {resource_name(r): v for r, v in res.items()}
                for pct, res in d.items()}

    return dict(
        aggregated_usage=by_pct(fields["aggregated_usage"]),
        aggregated_duration=fields["aggregated_duration"],
        aggregated_windows={dur: by_pct(d) for dur, d in
                            fields["aggregated_windows"].items()},
    )


def set_aggregated(metric, rng) -> None:
    """Give one typed ``NodeMetric`` seeded percentiles around its
    ``node_usage``, in place."""
    usage = {int(r): int(v) for r, v in metric.node_usage.items()}
    for key, value in typed_aggregated(aggregated_fields(rng, usage)).items():
        setattr(metric, key, value)


def add_aggregated_usage(snap, seed: int = 5):
    """Every metric of ``snap`` (port types) with seeded percentiles, in
    node order. Returns ``snap``."""
    rng = np.random.default_rng(seed)
    for node in snap.nodes:
        metric = snap.node_metrics.get(node.name)
        if metric is not None:
            set_aggregated(metric, rng)
    return snap


def chain_world_spec(seed: int = 18, n_nodes: int = 500,
                     n_pending: int = 256, n_quota: int = 8,
                     n_resv: int = 16, assigned_per_node: int = 2,
                     aggregated: bool = False, now: float = 100.0) -> dict:
    """The batched-round vs plugin-chain world as plain data for
    ``testing.build_snapshot``: ``n_nodes`` nodes of three sizes, a
    metric on every node (percentiles with ``aggregated``), assigned pods
    without quota, ``n_pending`` pending pods in ``n_quota`` root-level
    quota groups (so no resident is a same-quota preemption victim), a
    third of them labelled for one of ``n_resv`` label-owned
    reservations, each on a random node. No gangs. Times are relative to
    ``now`` (metrics 10 s old, assignments 50 s old), so a loop that reads
    the wall clock can take it."""
    rng = np.random.default_rng(seed)
    nodes = [
        dict(name=f"n{i}",
             alloc={_CPU: int(rng.choice([16000, 32000, 64000])),
                    _MEM: int(rng.choice([32768, 65536, 131072]))},
             labels={}, unschedulable=False)
        for i in range(n_nodes)
    ]
    assigned = []
    for j in range(assigned_per_node * n_nodes):
        assigned.append(dict(
            name=f"a{j}", node_name=f"n{int(rng.integers(0, n_nodes))}",
            assign_time=now - 50.0, requests={
                _CPU: int(rng.integers(200, 3000)),
                _MEM: int(rng.integers(128, 4096))},
            limits={}))
    metrics = []
    for i, n in enumerate(nodes):
        usage = {_CPU: int(n["alloc"][_CPU] * rng.uniform(0.05, 0.6)),
                 _MEM: int(n["alloc"][_MEM] * rng.uniform(0.05, 0.8))}
        m = dict(node_name=n["name"], node_usage=usage, pod_usages={},
                 update_time=now - 10.0, report_interval=60.0)
        if aggregated:
            m.update(aggregated_fields(rng, usage))
        metrics.append(m)
    total_cpu = sum(n["alloc"][_CPU] for n in nodes)
    total_mem = sum(n["alloc"][_MEM] for n in nodes)
    quotas = [
        dict(name=f"q{k}", parent="root",
             min={_CPU: total_cpu // (8 * n_quota),
                  _MEM: total_mem // (8 * n_quota)},
             max={_CPU: int(n_pending * 1700 / n_quota
                            * rng.uniform(0.5, 1.2)),
                  _MEM: int(n_pending * 2500 / n_quota
                            * rng.uniform(0.5, 1.2))})
        for k in range(n_quota)
    ]
    pending = []
    for j in range(n_pending):
        labels = ({"team": f"t{int(rng.integers(0, n_resv))}"}
                  if rng.uniform() < 1 / 3 else {})
        pending.append(dict(
            name=f"p{j}",
            requests={_CPU: int(rng.integers(500, 3000)),
                      _MEM: int(rng.integers(256, 5000))},
            limits={}, priority=int(rng.integers(0, 3)),
            quota=f"q{int(rng.integers(0, n_quota))}", labels=labels,
            preemptible=bool(rng.uniform() >= 0.1)))
    reservations = [
        dict(name=f"r{k}",
             requests={_CPU: int(rng.integers(2000, 8000)),
                       _MEM: int(rng.integers(2000, 8000))},
             allocatable={}, allocated={},
             node_name=f"n{int(rng.integers(0, n_nodes))}",
             state="Available", allocate_once=bool(k % 2),
             owner_labels={"team": f"t{k}"}, owner_pod_uids=[])
        for k in range(n_resv)
    ]
    return dict(now=now, nodes=nodes, assigned=assigned, pending=pending,
                metrics=metrics, quotas=quotas, gangs=[],
                reservations=reservations)
