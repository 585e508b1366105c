"""The port's placement explainer (``obs/explain.py``) against the JAX
package's and the oracle's, on the CPU (counterparts of
``tests/test_obs.py``'s explain cases and its ``/explain`` route).

On the reference's full-feature scenario (quota, a reservation, stale
and overloaded metrics, prod and selector pods), and on the
phase-17 (b) world in the aggregated mode: ``explain_scores``'s columns
equal the JAX package's and the oracle's scalar functions on the same
lowered arrays; ``PlacementExplainer``'s winner is ``schedule_one``'s
node and its feasible nodes' weighted totals are the chain's recorded
scores; the unschedulable and selector payloads; ``/explain`` over the
port's debug mux; and the payload equals the reference's key for key.
Bit for bit, no tolerance."""

import json
import urllib.request

import numpy as np
import pytest

from koordinator_tpu_torch import testing
from koordinator_tpu_torch.obs.trace import TRACER
from koordinator_tpu_torch.testing import plugin_chain
from koordinator_tpu_torch.utils.debug_http import DebugHTTPServer

from test_torch_framework import BOTH, PORT, REF

CPU, MEM = 0, 1


def full_feature_scheduler(P):
    """The reference's ``_full_feature_scheduler`` on package ``P``."""
    s = P.Scheduler(model=P.model())
    for i in range(8):
        s.add_node(P.node(f"n{i}", labels={"zone": "a" if i < 4 else "b"}))
        # n6 stale metric, n7 overloaded
        s.update_node_metric(P.metric(
            f"n{i}", {CPU: 15000 if i == 7 else 1000 * i, MEM: 2048 * i},
            update_time=1.0 if i == 6 else 90.0))
    s.update_quota(P.quota("q", {CPU: 2000, MEM: 1024}, {CPU: 6000, MEM: 4096}))
    s.update_reservation(P.resv("resv-a", {CPU: 2000}, "n2",
                                owner_pod_uids=["default/owned"]))
    PC = P.X.PriorityClass
    s.add_pod(P.pod("plain", {CPU: 1500, MEM: 512}))
    s.add_pod(P.pod("prod", {CPU: 2000, MEM: 1024},
                    priority_class=PC.PROD, qos=P.X.QoSClass.LS))
    s.add_pod(P.pod("quota-pod", {CPU: 1000, MEM: 256}, quota="q"))
    s.add_pod(P.pod("picky", {CPU: 500, MEM: 128},
                    node_selector={"zone": "b"}))
    s.add_pod(P.pod("owned", {CPU: 800, MEM: 128}))
    s.add_pod(P.pod("be-pod", {CPU: 400, MEM: 64}, qos=P.X.QoSClass.BE))
    return s


def chain_scheduler(P, n_nodes=60, n_pending=24):
    """The phase-17 (b) world, cut, in the aggregated mode."""
    spec = plugin_chain.chain_world_spec(n_nodes=n_nodes,
                                         n_pending=n_pending, aggregated=True)
    agg = P.cluster.AggregatedArgs(
        usage_thresholds=P.res({CPU: 65, MEM: 95}), usage_pct=99,
        score_pct=50)
    s = P.Scheduler(model=P.model(aggregated=agg))
    testing.feed_scheduler(s, P.snapshot(spec))
    return s, spec["now"]


def _oracle_columns(P, s, snapshot, pod, arrays):
    pa = P.cluster.lower_pending_pods(
        [pod], scaling_factors=s.model.scaling_factors,
        resource_weights=s.model.resource_weights)
    req, est = pa.req[0], pa.est[0]
    is_prod, is_ds = bool(pa.is_prod[0]), bool(pa.is_daemonset[0])
    weights = np.asarray(s.model.params.weights)
    thr = np.asarray(s.model.params.thresholds)
    prod_thr = np.asarray(s.model.params.prod_thresholds)
    o = P.oracle
    cols = {k: [] for k in ("fit_score", "loadaware_score", "fit_feasible",
                            "loadaware_feasible")}
    for i in range(arrays.n):
        cols["fit_score"].append(o.least_allocated_score_node(
            req, arrays.alloc[i], arrays.used_req[i], weights))
        cols["loadaware_score"].append(o.loadaware_score_node(
            est, arrays.alloc[i], arrays.usage[i], arrays.est_extra[i],
            arrays.prod_base[i], bool(arrays.metric_fresh[i]), weights,
            is_prod, s.model.config.score_according_prod))
        cols["fit_feasible"].append(o.fit_filter_node(
            req, arrays.alloc[i], arrays.used_req[i]))
        cols["loadaware_feasible"].append(o.loadaware_filter_node(
            arrays.alloc[i], arrays.usage[i], arrays.prod_usage[i],
            bool(arrays.metric_fresh[i]), thr, prod_thr, is_ds, is_prod))
    return {k: [int(v) for v in vals] for k, vals in cols.items()}


@pytest.mark.parametrize("world", ["full_feature", "aggregated_chain"])
def test_explain_columns_match_oracle_and_reference(world):
    got = {}
    for P in BOTH:
        if world == "full_feature":
            s, now = full_feature_scheduler(P), 100.0
        else:
            s, now = chain_scheduler(P)
        snapshot = s.cache.snapshot(now=now)
        assert snapshot.pending_pods
        per_pod = {}
        for pod in snapshot.pending_pods:
            arrays, cols = P.explain.explain_scores(s.model, snapshot, pod)
            oracle = _oracle_columns(P, s, snapshot, pod, arrays)
            for name, want in oracle.items():
                assert [int(v) for v in cols[name]] == want, (pod.name, name)
            assert cols["schedulable"].dtype == bool
            per_pod[pod.uid] = {k: np.asarray(v).astype(np.int64).tolist()
                                for k, v in cols.items()}
        got[P.root] = per_pod
    assert got["koordinator_tpu"] == got["koordinator_tpu_torch"]


def test_percent_rounded_pins_the_float64_deviation():
    """The chain's exact ``percent_rounded`` and the reference's literal
    float64 form (``percent_rounded_go_float64``) equal the JAX package's
    on a grid, and differ exactly on the .5 boundaries the float64
    division lands just below the half (23/40 is 58 exact, 57 there)."""
    ref, port = (P.oracle for P in BOTH)
    assert port.percent_rounded(23, 40) == 58
    assert port.percent_rounded_go_float64(23, 40) == 57
    differ = []
    for u in range(0, 300):
        for t in range(0, 300):
            exact = port.percent_rounded(u, t)
            f64 = port.percent_rounded_go_float64(u, t)
            assert exact == ref.percent_rounded(u, t), (u, t)
            assert f64 == ref.percent_rounded_go_float64(u, t), (u, t)
            if exact != f64:
                assert (200 * u) % (2 * t) == t and exact == f64 + 1, (u, t)
                differ.append((u, t))
    assert (23, 40) in differ


@pytest.mark.parametrize("world", ["full_feature", "aggregated_chain"])
def test_explain_winner_matches_incremental_chain(world):
    """The explainer's winner is the chain's node for pods the chain
    scores as the explainer does: no reservation credit (no owner match)
    and quota admitted (a refused pod's verdict says why)."""
    got = {}
    for P in BOTH:
        if world == "full_feature":
            s, now = full_feature_scheduler(P), 100.0
            pods = ["default/plain"]
        else:
            s, now = chain_scheduler(P)
            pods = [p.uid for p in s.cache.pending.values()
                    if not p.labels][:8]
        explainer = P.explain.PlacementExplainer(s)
        s.debug.dump_scores = True
        answers, bound = [], 0
        for uid in pods:
            payload = explainer.explain(uid, now=now)
            assert not payload["verdicts"].get("reservation_matches")
            outcome = s.schedule_one(uid, now=now)
            answers.append((payload, outcome.status, outcome.node))
            assert list(s.debug.explains)[-1] is payload
            if payload["verdicts"].get("quota_admitted") is False:
                assert outcome.status == "unschedulable"
                assert "insufficient quota" in outcome.reason
                continue
            assert payload["winner"] == outcome.node, uid
            bound += outcome.status == "bound"
            chain_scores = s.debug.scores[-1]["scores"]
            for detail in payload["top_nodes"]:
                if detail["feasible"]:
                    assert (detail["scores"]["weighted_total"]
                            == chain_scores[detail["node"]]), detail["node"]
        assert bound
        got[P.root] = answers
    # the payload is the reference's, key for key
    assert got["koordinator_tpu"] == got["koordinator_tpu_torch"]


def test_explain_unschedulable_and_selector():
    got = []
    for P in BOTH:
        s = full_feature_scheduler(P)
        picky = P.explain.PlacementExplainer(s).explain(
            "default/picky", node="n0", now=100.0)
        assert picky["filter_rejections"]["selector"] == 4
        assert picky["queried_node"]["filters"]["selector"] is False
        assert picky["winner"] is not None
        s.add_pod(P.pod("impossible", {CPU: 10 ** 8}))
        impossible = P.explain.PlacementExplainer(s).explain(
            "default/impossible", now=100.0)
        assert impossible["winner"] is None
        assert impossible["feasible_count"] == 0
        assert impossible["filter_rejections"]["fit"] == 8
        quota = P.explain.PlacementExplainer(s).explain(
            "default/quota-pod", node="nope", now=100.0)
        assert quota["verdicts"]["quota_admitted"] is True
        assert quota["queried_node"] == {"error": "unknown node 'nope'"}
        owned = P.explain.PlacementExplainer(s).explain("default/owned",
                                                        now=100.0)
        assert owned["verdicts"]["reservation_matches"] == ["resv-a"]
        unknown = P.explain.PlacementExplainer(s).explain("default/ghost")
        got.append((picky, impossible, quota, owned, unknown))
    assert got[0] == got[1]


def test_explain_over_the_debug_mux():
    s = full_feature_scheduler(PORT)
    server = DebugHTTPServer(
        services=s.services, debug=s.debug, tracer=TRACER,
        explain=PORT.explain.PlacementExplainer(s).explain).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        with urllib.request.urlopen(
                f"{base}/explain?pod=default/plain&node=n0",
                timeout=10) as resp:
            payload = json.loads(resp.read())
        assert payload["winner"] is not None
        assert payload["queried_node"]["node"] == "n0"
        with urllib.request.urlopen(f"{base}/debug/dumps",
                                    timeout=10) as resp:
            dumps = json.loads(resp.read())
        assert dumps["explains"]  # the explain above was recorded
    finally:
        server.stop()
    # the payload served is the reference explainer's on the same world
    ref = full_feature_scheduler(REF)
    want = REF.explain.PlacementExplainer(ref).explain(
        "default/plain", node="n0", now=None)
    assert {k: v for k, v in payload.items()} == json.loads(json.dumps(want))
