"""The LoadAware aggregated (percentile) mode in the port against the JAX
package, on the CPU.

The cases of the reference's ``tests/test_loadaware_aggregated.py`` that
need no koordlet reporter run on the port, each also checked against the
reference's answer; then the lowering of the phase-17 world under every
arm (filter only, score only, both, windows, the negative-``est_extra``
arm), the negative-``est_extra`` world through the loop solve, the
kernel's plain version and the reference, delta == full staging over
three ticks of an aggregated churn (and equal to the reference's rounds),
and ``build_scheduler``'s ``AggregatedArgs`` equal to the reference's.
Bit for bit, no tolerance."""

import dataclasses

import numpy as np
import pytest
import torch

from koordinator_tpu_torch import testing
from koordinator_tpu_torch.cmd.scheduler import SchedulerConfig, build_scheduler
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.ops.binpack import STAGED_NODE_FIELDS, solve_batch
from koordinator_tpu_torch.testing import plugin_chain

from test_torch_framework import BOTH, PORT, REF

CPU, MEM = 0, 1


def _snap(P, avg_cpu=5000, p95_cpu=7000, agg_duration=300.0, n=1):
    nodes = [P.node(f"n{i}", 10000, 32768) for i in range(n)]
    metrics = {
        f"n{i}": P.metric(
            f"n{i}", {CPU: avg_cpu},
            aggregated_usage={95: P.res({CPU: p95_cpu}),
                              50: P.res({CPU: avg_cpu // 2})},
            aggregated_duration=agg_duration)
        for i in range(n)
    }
    pod = P.pod("p", {CPU: 1000, MEM: 1024})
    return P.T.ClusterSnapshot(nodes=nodes, node_metrics=metrics,
                               pending_pods=[pod], now=100.0)


def _agg(P, **kw):
    if "usage_thresholds" in kw:
        kw["usage_thresholds"] = P.res(kw["usage_thresholds"])
    return P.cluster.AggregatedArgs(**kw)


FILTER95 = dict(usage_thresholds={CPU: 65}, usage_pct=95)


def _place(P, snap, **agg):
    model = P.model(aggregated=_agg(P, **agg) if agg else None)
    return model.schedule(snap)["default/p"]


@pytest.mark.parametrize("avg, p95, plain, aggregated", [
    (5000, 7000, "n0", None),    # avg admits, p95 rejects
    (5000, 6000, "n0", "n0"),    # p95 60% under 65%
    (7000, 5000, None, "n0"),    # avg rejects, p95 admits
])
def test_filter_substitutes_the_percentile(avg, p95, plain, aggregated):
    for P in BOTH:
        assert _place(P, _snap(P, avg, p95)) == plain
        assert _place(P, _snap(P, avg, p95), **FILTER95) == aggregated


def test_missing_percentile_skips_check():
    for P in BOTH:
        snap = _snap(P, avg_cpu=9900, p95_cpu=9900)
        for m in snap.node_metrics.values():
            m.aggregated_usage = {}
            m.aggregated_duration = None
        assert _place(P, snap, **FILTER95) == "n0"


def test_duration_mismatch_skips_check():
    for P in BOTH:
        assert _place(P, _snap(P, p95_cpu=9000), **FILTER95,
                      usage_duration_seconds=600.0) == "n0"
        assert _place(P, _snap(P, p95_cpu=9000), **FILTER95,
                      usage_duration_seconds=300.0) is None


def test_score_aggregated_prefers_calm_p95_node():
    for P in BOTH:
        def snap2():
            nodes = [P.node(f"n{i}", 10000, 32768) for i in range(2)]
            metrics = {
                name: P.metric(name, {CPU: 4000},
                               aggregated_usage={95: P.res({CPU: p95})},
                               aggregated_duration=300.0)
                for name, p95 in (("n0", 8000), ("n1", 5000))}
            return P.T.ClusterSnapshot(
                nodes=nodes, node_metrics=metrics,
                pending_pods=[P.pod("p", {CPU: 1000, MEM: 1024})], now=100.0)

        assert _place(P, snap2()) == "n0"
        assert _place(P, snap2(), score_pct=95) == "n1"


def test_score_aggregated_nil_estimates_all_assigned():
    got = []
    for P in BOTH:
        assigned = P.pod("a", {CPU: 2000, MEM: 1024}, node_name="n0",
                         assign_time=0.0)
        metric = P.metric("n0", {CPU: 6000},
                          pod_usages={"default/a": P.res({CPU: 1000})},
                          report_interval=10.0)
        snap = P.T.ClusterSnapshot(nodes=[P.node("n0", 10000, 32768)],
                                   pods=[assigned],
                                   node_metrics={"n0": metric}, now=100.0)
        arrays = P.cluster.lower_nodes(snap, aggregated=_agg(P, score_pct=95))
        # the filter side is untouched; the score base is the bare pod
        # estimate max(2000 * 85%, 1000) with the node usage dropped
        assert arrays.usage[0, CPU] == 6000
        assert arrays.usage[0, CPU] + arrays.est_extra[0, CPU] == 1700
        got.append(np.asarray(arrays.est_extra).tolist())
    assert got[0] == got[1]


def test_target_aggregated_usage_selection():
    for P in BOTH:
        target = P.cluster.target_aggregated_usage
        m = P.T.NodeMetric(node_name="n",
                           aggregated_usage={95: P.res({CPU: 5})},
                           aggregated_duration=300.0)
        assert target(m, None, 95) == P.res({CPU: 5})
        assert target(m, 300.0, 95) == P.res({CPU: 5})
        assert target(m, 600.0, 95) is None
        assert target(m, None, 90) is None
        assert target(P.T.NodeMetric(node_name="n"), None, 95) is None


def test_target_aggregated_usage_multi_window():
    for P in BOTH:
        target = P.cluster.target_aggregated_usage
        m = P.T.NodeMetric(
            node_name="n", aggregated_usage={95: P.res({CPU: 5})},
            aggregated_duration=300.0,
            aggregated_windows={900.0: {95: P.res({CPU: 7})},
                                1800.0: {95: P.res({CPU: 9}),
                                         50: P.res({CPU: 2})}})
        assert target(m, 300.0, 95) == P.res({CPU: 5})
        assert target(m, 900.0, 95) == P.res({CPU: 7})
        assert target(m, None, 95) == P.res({CPU: 9})  # the largest window
        assert target(m, None, 50) == P.res({CPU: 2})
        assert target(m, 1200.0, 95) is None


def test_invalid_percentile_refused():
    for P in BOTH:
        with pytest.raises(ValueError, match="not reported"):
            _agg(P, score_pct=97)


def test_incremental_path_applies_aggregated_mode():
    """Both paths apply the model's aggregated profile: the chain's cycle
    lowers with it (cycle seed -> node_view), so p95 rejects there too."""
    for P in BOTH:
        for agg, expected in ((FILTER95, None), ({}, "n0")):
            for batched in (True, False):
                s = P.Scheduler(model=P.model(
                    aggregated=_agg(P, **agg) if agg else None))
                s.batched_placement = batched
                snap = _snap(P)  # avg 50% admits, p95 70% rejects at 65
                s.add_node(snap.nodes[0])
                s.update_node_metric(snap.node_metrics["n0"])
                s.update_pod(snap.pending_pods[0])
                out = s.schedule_pending(now=100.0)
                assert out["default/p"] == expected, (P.root, batched, agg)


def test_incremental_lowering_uses_model_scaling_factors():
    for P in BOTH:
        snap = P.T.ClusterSnapshot(
            nodes=[P.node("n0", 10000, 32768)],
            pods=[P.pod("a", {CPU: 2000}, node_name="n0", assign_time=99.5)],
            node_metrics={"n0": P.metric("n0", {CPU: 100},
                                         report_interval=10.0)},
            now=100.0)
        s = P.Scheduler(model=P.model(scaling_factors=P.res({CPU: 50,
                                                             MEM: 70})))
        view = P.lowering.node_view(P.fw.CycleState(s.framework.cycle_seed),
                                    snap)
        assert view.arrays.est_extra[0, CPU] == 1000
        default = P.Scheduler(model=P.model())
        view2 = P.lowering.node_view(
            P.fw.CycleState(default.framework.cycle_seed), snap)
        assert view2.arrays.est_extra[0, CPU] == 1700


ARMS = {
    "filter99": dict(usage_thresholds={CPU: 65, MEM: 95}, usage_pct=99),
    "score99": dict(score_pct=99),
    "both99": dict(usage_thresholds={CPU: 65, MEM: 95}, usage_pct=99,
                   score_pct=99),
    "filter99_score50": dict(usage_thresholds={CPU: 65, MEM: 95},
                             usage_pct=99, score_pct=50),
    "primary_window": dict(usage_thresholds={CPU: 65, MEM: 95}, usage_pct=95,
                           usage_duration_seconds=300.0, score_pct=90,
                           score_duration_seconds=300.0),
    "missing_window": dict(usage_thresholds={CPU: 65}, usage_pct=95,
                           usage_duration_seconds=600.0, score_pct=90,
                           score_duration_seconds=900.0),
}


def _chain_spec():
    spec = plugin_chain.chain_world_spec(seed=4, n_nodes=60, n_pending=48,
                                         aggregated=True)
    # estimated pods with reported usage, so the score-base guard is hit
    for m in spec["metrics"][::3]:
        for p in spec["assigned"]:
            if p["node_name"] == m["node_name"]:
                m["pod_usages"][f"default/{p['name']}"] = {CPU: 700,
                                                           MEM: 900}
    for p in spec["assigned"][::4]:
        p["assign_time"] = 95.0
    return spec


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_lowering_matches_reference(arm):
    """Full, delta and row lowerings of the phase-17 world under each arm
    equal the reference's."""
    spec = _chain_spec()
    got = {}
    for P in BOTH:
        agg = _agg(P, **ARMS[arm])
        snap = P.snapshot(spec)
        full = P.cluster.lower_nodes(snap, aggregated=agg)
        names = [n["name"] for n in spec["nodes"][::7]]
        rows = P.cluster.lower_node_rows(snap, names, aggregated=agg)
        base = P.cluster.lower_nodes(snap)
        idx = P.cluster.lower_nodes_delta(snap, base, names, aggregated=agg)
        for name in names:
            i = base.index()[name]
            for f in STAGED_NODE_FIELDS:
                assert np.array_equal(np.asarray(getattr(base, f))[i],
                                      np.asarray(getattr(full, f))[i]), f
        got[P.root] = (
            {f: np.asarray(getattr(full, f)).tolist()
             for f in STAGED_NODE_FIELDS},
            {f: np.asarray(v).tolist() for f, v in rows.items()},
            np.asarray(idx).tolist())
    assert got["koordinator_tpu"] == got["koordinator_tpu_torch"]
    if arm == "filter99_score50":
        assert min(min(r) for r in got["koordinator_tpu"][0]["est_extra"]) < 0


def test_negative_est_extra_loop_equals_kernel_plain_and_reference():
    """Filter at p99, score at p50: ``est_extra`` goes negative (the score
    base does not). The loop solve, the kernel's plain version (one
    block and two CTAs) and the reference place alike (no quota groups
    or reservations, so the direct solves see the model's whole input)."""
    spec = _chain_spec()
    spec["reservations"] = []
    for p in spec["pending"]:
        p["quota"] = None
    arm = ARMS["filter99_score50"]
    want = REF.model(aggregated=_agg(REF, **arm)).schedule(REF.snapshot(spec))
    model = PORT.model(aggregated=_agg(PORT, **arm))
    snap = PORT.snapshot(spec)
    arrays = PORT.cluster.lower_nodes(snap, **model.lowering_kwargs())
    assert (arrays.est_extra < 0).any()
    assert ((arrays.usage + arrays.est_extra) >= 0).all()
    pods = PORT.cluster.lower_pending_pods(
        snap.pending_pods, scaling_factors=model.scaling_factors,
        resource_weights=model.resource_weights)
    state, batch = model.stage_nodes(arrays), model.stage_pods(pods)
    loop = solve_batch(state, batch, model.params, model.config)
    inp = bk.kernel_inputs(state, batch, model.params)
    plain = bk.binpack_plain(inp)
    sharded = bk.binpack_sharded_plain(inp, 2)
    assert torch.equal(loop.assign, plain.assign)
    assert torch.equal(plain.assign, sharded.assign)
    for f in ("used", "est", "prod"):
        assert torch.equal(getattr(plain, f), getattr(sharded, f)), f
    got = model.schedule(PORT.snapshot(spec))
    assert dict(got) == dict(want)
    assert sum(n is not None for n in got.values()) > 0
    by_index = {uid: (arrays.names[int(a)] if a >= 0 else None)
                for uid, a in zip(pods.uids, plain.assign.tolist())}
    assert by_index == dict(got)


def _tick_events(rng, spec, t, now, dirty=6, pending=12):
    """One aggregated churn tick as plain data: ``dirty`` fresh metrics
    with percentiles, and a pending wave."""
    metrics = []
    for i in rng.choice(len(spec["nodes"]), dirty, replace=False):
        node = spec["nodes"][int(i)]
        usage = {CPU: int(node["alloc"][CPU] * rng.uniform(0.05, 0.7)),
                 MEM: int(node["alloc"][MEM] * rng.uniform(0.05, 0.8))}
        metrics.append((node["name"], usage,
                        plugin_chain.aggregated_fields(rng, usage)))
    pods = [(f"t{t}p{j}", {CPU: int(rng.integers(300, 3000)),
                           MEM: int(rng.integers(256, 4096))})
            for j in range(pending)]
    return metrics, pods


def _record_lowering(P, model):
    """Wrap ``model.schedule_async`` to record a full lowering of each
    snapshot it is handed, taken before the solve."""
    fresh = []
    dispatch = model.schedule_async

    def record(snap):
        fresh.append(P.cluster.lower_nodes(snap, **model.lowering_kwargs()))
        return dispatch(snap)

    model.schedule_async = record
    return fresh


def test_delta_equals_full_over_aggregated_ticks():
    """Four churn ticks in the aggregated mode (filter p99, score p50):
    every tick after the first re-lowers only the marked rows, the staged
    world equals a full lowering of the same snapshot and the reference's,
    and the rounds equal the reference's."""
    spec = _chain_spec()
    arm = ARMS["filter99_score50"]
    scheds, fresh = {}, {}
    for P in BOTH:
        s = P.Scheduler(model=P.model(aggregated=_agg(P, **arm)),
                        enable_preemption=False)
        testing.feed_scheduler(s, P.snapshot(spec))
        scheds[P.root] = s
        fresh[P.root] = _record_lowering(P, s.model)
    rng = np.random.default_rng(9)
    port = scheds["koordinator_tpu_torch"]
    for t in range(4):
        now = 100.0 + t
        metrics, pods = _tick_events(rng, spec, t, now)
        for P in BOTH:
            s = scheds[P.root]
            for name, usage, fields in metrics:
                s.update_node_metric(P.metric(
                    name, usage, update_time=now,
                    **plugin_chain.typed_aggregated(fields,
                                                    P.X.ResourceName)))
            for name, req in pods:
                s.add_pod(P.pod(name, req))
        want = scheds["koordinator_tpu"].schedule_pending(now=now)
        got = port.schedule_pending(now=now)
        assert dict(got) == dict(want), t
        assert port.model.last_staging == ("full" if t == 0 else "delta")
        staged = port.model.staged_cache.state
        for f in STAGED_NODE_FIELDS:
            want_f = np.asarray(getattr(fresh["koordinator_tpu"][-1], f))
            assert np.array_equal(
                getattr(fresh["koordinator_tpu_torch"][-1], f), want_f), f
            assert np.array_equal(getattr(staged, f).numpy(), want_f), (t, f)
        assert (port.model.staged_cache.arrays.est_extra < 0).any()


def _args_view(args):
    if args is None:
        return None
    d = dataclasses.asdict(args)
    if d["usage_thresholds"] is not None:
        d["usage_thresholds"] = {int(k): v
                                 for k, v in d["usage_thresholds"].items()}
    return d


@pytest.mark.parametrize("fields", [
    # the case build_scheduler refused while the mode was not ported
    dict(aggregated_usage_pct=95),
    dict(aggregated_usage_thresholds={CPU: 65, MEM: 95},
         aggregated_usage_pct=99, aggregated_score_pct=99),
    dict(aggregated_usage_thresholds={CPU: 65, MEM: 95},
         aggregated_usage_pct=99, aggregated_score_pct=50,
         aggregated_usage_duration_seconds=300.0,
         aggregated_score_duration_seconds=1800.0),
    dict(aggregated_score_pct=90),
    dict(aggregated_usage_thresholds={CPU: 65}),
])
def test_build_scheduler_aggregated_args_match_reference(fields):
    """``aggregated_*`` become the model's ``AggregatedArgs`` as the
    reference's build_scheduler makes them, with the same filter
    thresholds, on both paths of the BatchedPlacement gate."""
    def conf(P, **extra):
        kw = dict(fields)
        if "aggregated_usage_thresholds" in kw:
            kw["aggregated_usage_thresholds"] = P.res(
                kw["aggregated_usage_thresholds"])
        return P.cmd.SchedulerConfig(**kw, **extra)

    ref = REF.cmd.build_scheduler(conf(REF, warm_pool=False,
                                       host_fallback_cells=0))
    for spec in ("", "BatchedPlacement=false,ElasticQuotaPreemption=false"):
        port = build_scheduler(conf(PORT, feature_gates=spec,
                                    host_fallback_cells=0), device="cpu")
        assert _args_view(port.model.aggregated) == _args_view(
            ref.model.aggregated)
        assert ({int(k): v for k, v in port.model.usage_thresholds.items()}
                == {int(k): v for k, v in ref.model.usage_thresholds.items()})
        np.testing.assert_array_equal(port.model.params.thresholds.numpy(),
                                      np.asarray(ref.model.params.thresholds))
        assert port.batched_placement == (spec == "")
        assert port._quota_plugin.enable_preemption == (spec == "")
        assert port.model.lowering_kwargs()["aggregated"] is \
            port.model.aggregated


def test_build_scheduler_reads_the_feature_gates():
    from koordinator_tpu.features import SCHEDULER_GATES as REF_GATES
    from koordinator_tpu_torch.features import SCHEDULER_GATES

    # the port registers only the gates it reads, with the reference's
    # defaults; an upstream gate it does not read is refused by name
    assert SCHEDULER_GATES.as_dict() == {
        name: REF_GATES.enabled(name)
        for name in ("BatchedPlacement", "ElasticQuotaPreemption")}
    gates = SCHEDULER_GATES.copy()
    gates.set_from_spec("BatchedPlacement=false, ElasticQuotaPreemption=false")
    assert not gates.enabled("BatchedPlacement")
    assert not gates.enabled("ElasticQuotaPreemption")
    with pytest.raises(KeyError, match="unknown feature gate"):
        gates.set_from_spec("ResizePod=true")
    assert not gates.enabled("BatchedPlacement")  # refused spec: untouched
    assert SCHEDULER_GATES.enabled("BatchedPlacement")  # the copy's own
    with pytest.raises(KeyError):
        gates.enabled("NoSuchGate")
    plain = build_scheduler(SchedulerConfig(host_fallback_cells=0),
                            device="cpu")
    assert plain.batched_placement and plain._quota_plugin.enable_preemption
    assert plain.model.aggregated is None
    with pytest.raises(KeyError, match="unknown feature gate"):
        build_scheduler(SchedulerConfig(feature_gates="NoSuchGate=true"),
                        device="cpu")
    with pytest.raises(ValueError, match="invalid feature gate"):
        build_scheduler(SchedulerConfig(feature_gates="BatchedPlacement"),
                        device="cpu")
