"""The port's manager-side analysis against the JAX package's: the
recommendation API (``apis/analysis.py``), the koordlet's prediction
banks (``koordlet/prediction``: ``HistogramBank``, ``PeakPredictServer``
with its checkpoint, ``prod_reclaimable``), the recommendation
controller with its index and webhook wiring
(``manager/recommendation.py``), the nodemetric collect policy
(``manager/nodemetric.py``) and the ElasticQuotaProfile controller
(``quota/profile.py``). The cases are those of
``tests/test_recommendation.py``, ``tests/test_prediction_informer.py``
(``TestHistogramBank``, ``TestPeakPredictServer``,
``TestProdReclaimable``), ``tests/test_manager.py::TestCollectPolicy``
and ``tests/test_quota_preemption.py::TestProfileController``, run
through both packages on the same inputs; each asserts the reference's
expectations and returns what it observed, and the two must be equal
bit for bit (the banks' float64 weights included)."""

import dataclasses
import enum
import importlib
import random

import numpy as np
import pytest

CPU, MEM = 0, 1
WORKLOAD = "Deployment/default/web"


class Pkg:
    def __init__(self, root):
        mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        self.root = root
        self.T = mod("apis.types")
        self.X = mod("apis.extension")
        self.A = mod("apis.analysis")
        self.H = mod("koordlet.prediction.histogram")
        self.PS = mod("koordlet.prediction.predict_server")
        self.PR = mod("koordlet.prediction.predictor")
        self.RC = mod("manager.recommendation")
        self.NM = mod("manager.nodemetric")
        self.S = mod("manager.sloconfig")
        self.QP = mod("quota.profile")
        self.bus = mod("client.bus")
        self.LE = mod("client.leaderelection")
        self.W = mod("webhook")
        self._sched = mod("scheduler.scheduler").Scheduler
        self._model = mod("models.placement").PlacementModel

    def res(self, d):
        return {self.X.ResourceName(k): v for k, v in d.items()}

    def scheduler(self):
        if self.root == "koordinator_tpu":
            return self._sched(model=self._model(use_pallas=False))
        return self._sched(model=self._model(device="cpu"))


REF = Pkg("koordinator_tpu")
PORT = Pkg("koordinator_tpu_torch")


def plain(x):
    if isinstance(x, enum.Enum):
        return x.name
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


# -- the histogram bank, the predict server, the predictor ---------------------


def h_constant_and_orders(P):
    h = P.H.HistogramBank(first_bucket=25.0)
    for t in range(100):
        h.add("a", 500.0, float(t))
    p95 = h.percentile("a", 0.95)
    assert 500 / 1.05 <= p95 <= 500
    for t in range(90):
        h.add("b", 100.0, float(t))
    for t in range(90, 100):
        h.add("b", 2000.0, float(t))
    p50, p99 = h.percentile("b", 0.5), h.percentile("b", 0.99)
    assert p50 < 200 and p99 >= 2000 / 1.05
    return [p95, p50, p99, h.state()]


def h_decay_and_unknown(P):
    h = P.H.HistogramBank(first_bucket=25.0, half_life_seconds=3600)
    h.add("a", 4000.0, 0.0)
    for i in range(100):
        h.add("a", 100.0, 72000.0 + i)
    assert h.percentile("a", 0.95) < 200
    assert h.percentile("ghost", 0.95) is None
    return [h.percentile("a", p) for p in (0.5, 0.95, 0.999)] + [h.state()]


def h_seeded_bank(P):
    """Many keys, decays between samples, a bank that grows past its
    first rows and a compaction: every weight equal bit for bit."""
    h = P.H.HistogramBank(first_bucket=5.0, half_life_seconds=900.0)
    rng = random.Random(0)
    keys = [f"k{i}" for i in range(40)]
    for step in range(600):
        h.add(rng.choice(keys), rng.uniform(0.0, 9000.0),
              float(step) * rng.uniform(0.5, 3.0), weight=rng.uniform(0.1, 2))
    batch = h.percentiles_batch(keys + ["ghost"], [0.5, 0.9, 0.95, 0.99])
    for i, key in enumerate(keys):
        for j, p in enumerate((0.5, 0.9, 0.95, 0.99)):
            assert batch[i][j] == h.percentile(key, p)
    h.forget(keys[::3])
    after = h.percentiles_batch(keys, [0.95])
    h2 = P.H.HistogramBank(first_bucket=5.0, half_life_seconds=900.0)
    h2.load_state(h.state())
    assert h2.percentiles_batch(keys, [0.95]) == after
    stale = P.H.HistogramBank(first_bucket=5.0)
    stale.load_state(dict(h.state(), version=1))
    return [batch, after, h.state(), stale.state(), h.first_seen("k0"),
            h.first_seen("k1")]


def s_server(P, tmp):
    cfg = P.PS.PredictionConfig(safety_margin_percent=10,
                                cold_start_seconds=900,
                                checkpoint_path=str(tmp / f"{P.root}.json"))
    s = P.PS.PeakPredictServer(cfg)
    for t in range(100):
        s.update(P.PS.pod_key("p"), 1000.0 + 7 * t, 512.0, float(t))
        s.update(P.PS.priority_key("batch"), 300.0, 64.0, float(t))
    peak = s.peak(P.PS.pod_key("p"))
    assert peak["cpu"] == pytest.approx(
        s.cpu.percentile(P.PS.pod_key("p"), 0.95) * 1.1)
    s.update(P.PS.pod_key("young"), 100.0, 10.0, 1000.0)
    cold = [s.in_cold_start(P.PS.pod_key("young"), 1100.0),
            s.in_cold_start(P.PS.pod_key("young"), 2000.0),
            s.in_cold_start(P.PS.pod_key("ghost"), 2000.0)]
    assert cold == [True, False, True]
    s.save_checkpoint()
    s2 = P.PS.PeakPredictServer(cfg)
    assert s2.load_checkpoint()
    assert s2.peak(P.PS.pod_key("p")) == peak
    assert not P.PS.PeakPredictServer(P.PS.PredictionConfig(
        checkpoint_path=str(tmp / "missing.json"))).load_checkpoint()
    batch = s.peaks_batch([P.PS.pod_key("p"), "ghost",
                           P.PS.priority_key("batch")])
    s.gc([P.PS.pod_key("p")])
    return [peak, cold, batch, s.cpu.state(), s.memory.state(),
            s2.cpu.state()]


def s_prod_reclaimable(P):
    s = P.PS.PeakPredictServer(P.PS.PredictionConfig(
        safety_margin_percent=0, cold_start_seconds=0))
    for t in range(1000):
        s.update(P.PS.pod_key("p"), 500.0, 256.0, float(t))
        s.update(P.PS.pod_key("q"), 1500.0, 900.0, float(t))
        s.update(P.PS.priority_key("prod"), 2000.0, 1156.0, float(t))
        s.update(P.PS.SYS_KEY, 100.0, 50.0, float(t))
    rec = P.PR.prod_reclaimable(s, [("p", 2000, 1024), ("q", 2000, 1024)],
                                now=1000.0)
    assert rec["cpu"] > 0
    cold = P.PS.PeakPredictServer(P.PS.PredictionConfig(
        cold_start_seconds=1e6))
    cold.update(P.PS.pod_key("p"), 100.0, 10.0, 0.0)
    rec_cold = P.PR.prod_reclaimable(cold, [("p", 2000, 1024)], now=100.0)
    assert rec_cold["cpu"] == 0
    return [rec, rec_cold]


# -- the recommendation controller ------------------------------------------------


def seed(P, bus, n_pods=3):
    bus.apply(P.bus.Kind.NODE, "n0", P.T.NodeSpec(
        name="n0", allocatable=P.res({CPU: 32000, MEM: 65536})))
    for i in range(n_pods):
        bus.apply(P.bus.Kind.POD, f"default/web-{i}", P.T.PodSpec(
            name=f"web-{i}", owner=WORKLOAD, node_name="n0",
            labels={"app": "web"}, requests=P.res({CPU: 4000, MEM: 8192})))


def report(P, bus, t, cpu, mem, n_pods=3):
    bus.apply(P.bus.Kind.NODE_METRIC, "n0", P.T.NodeMetric(
        node_name="n0", node_usage=P.res({CPU: cpu * n_pods,
                                          MEM: mem * n_pods}),
        pod_usages={f"default/web-{i}": P.res({CPU: cpu, MEM: mem})
                    for i in range(n_pods)},
        update_time=t))


def rec_view(P, bus, name="web"):
    return plain(bus.get(P.bus.Kind.RECOMMENDATION, name))


def r_no_samples(P):
    bus = P.bus.APIServer()
    c = P.RC.RecommendationController(bus)
    bus.apply(P.bus.Kind.RECOMMENDATION, "web", P.A.Recommendation(
        name="web", target=P.A.RecommendationTarget(workload=WORKLOAD)))
    assert c.run_once(now=10.0) == 1
    assert c.run_once(now=11.0) == 0  # the condition is published once
    rec = bus.get(P.bus.Kind.RECOMMENDATION, "web")
    assert rec.conditions[P.A.CONDITION_NO_SAMPLES] is True
    assert not rec.ready
    return rec_view(P, bus)


def r_peaks_become_status(P):
    bus = P.bus.APIServer()
    c = P.RC.RecommendationController(bus)
    bus.apply(P.bus.Kind.RECOMMENDATION, "web", P.A.Recommendation(
        name="web", target=P.A.RecommendationTarget(workload=WORKLOAD)))
    seed(P, bus)
    added = []
    for k in range(20):
        report(P, bus, t=float(k + 1), cpu=1000 + 37 * k, mem=2048)
        added.append(c.observe(now=float(k + 1)))
    assert c.reconcile(now=30.0) == 1
    assert c.reconcile(now=31.0) == 0  # unchanged: not republished
    rec = bus.get(P.bus.Kind.RECOMMENDATION, "web")
    assert rec.ready and rec.conditions[P.A.CONDITION_READY]
    assert 1000 <= rec.recommended[P.X.ResourceName.CPU] <= 2200
    assert 2048 <= rec.recommended[P.X.ResourceName.MEMORY] <= 2600
    return [added, rec_view(P, bus), c.server.cpu.state()]


def r_selector_and_dedup(P):
    bus = P.bus.APIServer()
    c = P.RC.RecommendationController(bus)
    bus.apply(P.bus.Kind.RECOMMENDATION, "by-label", P.A.Recommendation(
        name="by-label",
        target=P.A.RecommendationTarget(pod_selector={"app": "web"})))
    seed(P, bus, n_pods=1)
    report(P, bus, t=5.0, cpu=500, mem=1024, n_pods=1)
    out = [c.observe(now=5.0), c.observe(now=6.0)]
    report(P, bus, t=7.0, cpu=500, mem=1024, n_pods=1)
    out.append(c.observe(now=7.0))
    assert out == [1, 0, 1]
    # a target with neither workload nor selector covers nothing
    assert not P.A.RecommendationTarget().matches(
        bus.get(P.bus.Kind.POD, "default/web-0"))
    return out


def r_unmatched_pods(P):
    bus = P.bus.APIServer()
    c = P.RC.RecommendationController(bus)
    assert c.observe(now=0.5) == 0  # no Recommendation: nothing read
    bus.apply(P.bus.Kind.RECOMMENDATION, "web", P.A.Recommendation(
        name="web", target=P.A.RecommendationTarget(
            workload="Deployment/default/other")))
    seed(P, bus)
    report(P, bus, t=1.0, cpu=1000, mem=2048)
    assert c.observe(now=1.0) == 0
    return rec_view(P, bus)


def r_fresh_controller_keeps_ready(P):
    bus = P.bus.APIServer()
    bus.apply(P.bus.Kind.RECOMMENDATION, "web", P.A.Recommendation(
        name="web", target=P.A.RecommendationTarget(workload=WORKLOAD),
        recommended=P.res({CPU: 1200}), update_time=5.0,
        conditions={P.A.CONDITION_READY: True}))
    assert P.RC.RecommendationController(bus).reconcile(now=10.0) == 0
    rec = bus.get(P.bus.Kind.RECOMMENDATION, "web")
    assert rec.ready and rec.recommended == P.res({CPU: 1200})
    return rec_view(P, bus)


def r_preseeded_gains_ready(P):
    bus = P.bus.APIServer()
    c = P.RC.RecommendationController(bus)
    bus.apply(P.bus.Kind.RECOMMENDATION, "web", P.A.Recommendation(
        name="web", target=P.A.RecommendationTarget(workload=WORKLOAD),
        recommended=P.res({CPU: 550, MEM: 1123})))
    seed(P, bus, n_pods=1)
    for k in range(10):
        report(P, bus, t=float(k + 1), cpu=500, mem=1024, n_pods=1)
        c.observe(now=float(k + 1))
    assert c.reconcile(now=20.0) == 1
    assert bus.get(P.bus.Kind.RECOMMENDATION, "web").ready
    return rec_view(P, bus)


def r_deposed_publish_is_fenced(P):
    bus = P.bus.APIServer()
    ea = P.LE.LeaderElector(bus, "koord-manager", "a")
    eb = P.LE.LeaderElector(bus, "koord-manager", "b")
    c = P.RC.RecommendationController(bus, elector=ea)
    bus.apply(P.bus.Kind.RECOMMENDATION, "web", P.A.Recommendation(
        name="web", target=P.A.RecommendationTarget(workload=WORKLOAD)))
    seed(P, bus, n_pods=1)
    report(P, bus, t=1.0, cpu=500, mem=1024, n_pods=1)
    ea.tick(0.0)
    c.observe(now=1.0)
    eb.tick(20.0)
    with pytest.raises(P.LE.FencingError):
        c.reconcile(now=21.0)
    assert not bus.get(P.bus.Kind.RECOMMENDATION, "web").ready
    return rec_view(P, bus)


def wired_webhook(P, rec):
    bus = P.bus.APIServer()
    webhook = P.W.PodMutatingWebhook()
    controller = P.RC.wire_recommendation(bus, webhook)
    bus.apply(P.bus.Kind.RECOMMENDATION, rec.name, rec)
    return bus, webhook, controller


def r_right_sized_from_usage(P):
    bus, webhook, controller = wired_webhook(P, P.A.Recommendation(
        name="web", target=P.A.RecommendationTarget(workload=WORKLOAD)))
    seed(P, bus)
    for k in range(20):
        report(P, bus, t=float(k + 1), cpu=1000, mem=2048)
        controller.observe(now=float(k + 1))
    controller.reconcile(now=30.0)
    pod = webhook.mutate(P.T.PodSpec(name="web-new", owner=WORKLOAD,
                                     requests=P.res({CPU: 4000, MEM: 8192})))
    assert 1000 <= pod.requests[P.X.ResourceName.CPU] <= 1400
    assert 2048 <= pod.requests[P.X.ResourceName.MEMORY] <= 2600
    bus.delete(P.bus.Kind.RECOMMENDATION, "web")
    after = webhook.mutate(P.T.PodSpec(name="web-2", owner=WORKLOAD,
                                       requests=P.res({CPU: 4000})))
    assert after.requests == P.res({CPU: 4000})
    return plain([pod.requests, pod.limits, after.requests])


def r_ready_recommendations(P):
    ready = dict(update_time=1.0, conditions={P.A.CONDITION_READY: True})
    out = []
    for rec, pod in (
        (P.A.Recommendation(
            name="web", target=P.A.RecommendationTarget(workload=WORKLOAD),
            recommended=P.res({CPU: 3000}), **ready),
         P.T.PodSpec(name="p", owner=WORKLOAD, requests=P.res({CPU: 1000}),
                     limits=P.res({CPU: 2000}))),
        (P.A.Recommendation(
            name="web", target=P.A.RecommendationTarget(workload=WORKLOAD)),
         P.T.PodSpec(name="p", owner=WORKLOAD, requests=P.res({CPU: 1000}))),
        (P.A.Recommendation(
            name="web", target=P.A.RecommendationTarget(workload=WORKLOAD),
            recommended=P.res({CPU: 3000, MEM: 4096}), **ready),
         P.T.PodSpec(name="p", owner=WORKLOAD, requests=P.res({CPU: 1000}))),
    ):
        _, webhook, _ = wired_webhook(P, rec)
        webhook.mutate(pod)
        out.append(plain([pod.requests, pod.limits]))
    assert out == [[{"CPU": 3000}, {"CPU": 3000}], [{"CPU": 1000}, {}],
                   [{"CPU": 3000}, {}]]
    return out


# -- the nodemetric collect policy and the quota profile controller -----------------


def n_collect_policy(P):
    S = P.S
    out = [P.NM.node_metric_collect_policy(S.ColocationStrategy(enable=True)),
           P.NM.node_metric_collect_policy(S.ColocationStrategy()),
           P.NM.node_metric_collect_policy(S.ColocationStrategy(
               enable=True, degrade_time_minutes=0))]
    assert out[0].aggregate_duration_seconds == 300
    assert out[0].report_interval_seconds == 60
    assert out[1] is None and out[2] is None
    config = S.ColocationConfig(
        cluster_strategy=S.ColocationStrategy(enable=True),
        node_strategies=[
            S.NodeStrategySelector(match_labels={"pool": "fast"}, overrides={
                "metric_report_interval_seconds": 15}),
            S.NodeStrategySelector(match_labels={"pool": "off"},
                                   overrides={"enable": False})])
    out.append(P.NM.reconcile_collect_policies(config, {
        "a": {}, "b": {"pool": "fast"}, "c": {"pool": "off"}}))
    assert out[-1]["b"].report_interval_seconds == 15
    assert out[-1]["c"] is None
    return plain(out)


def q_profile_controller(P):
    s = P.scheduler()
    for name, cpu, pool in (("gpu-0", 8000, "gpu"), ("gpu-1", 8000, "gpu"),
                            ("cpu-0", 64000, "cpu")):
        s.add_node(P.T.NodeSpec(name=name, allocatable=P.res({CPU: cpu}),
                                labels={"pool": pool}))
    c = P.QP.QuotaProfileController(s)
    c.update_profile(P.QP.QuotaProfile(
        name="gpu-profile", quota_name="gpu-pool",
        node_selector={"pool": "gpu"}))
    c.update_profile(P.QP.QuotaProfile(
        name="cpu-profile", quota_name="cpu-pool", tree_id="fixed",
        node_selector={"pool": "cpu"}, resource_keys=(
            P.X.ResourceName.CPU,)))
    c.sync()
    spec = s.cache.quotas["gpu-pool"]
    assert spec.min[P.X.ResourceName.CPU] == 16000
    assert spec.total_resource[P.X.ResourceName.CPU] == 16000
    mgr = s.quota_registry.manager_for_quota("gpu-pool")
    assert mgr.cluster_total[CPU] == 16000
    first = [plain(s.cache.quotas["gpu-pool"]),
             plain(s.cache.quotas["cpu-pool"]),
             mgr.cluster_total.tolist()]
    s.add_node(P.T.NodeSpec(name="gpu-2", allocatable=P.res({CPU: 8000}),
                            labels={"pool": "gpu"}))
    c.remove_profile("cpu-profile")
    c.sync()
    assert s.cache.quotas["gpu-pool"].min[P.X.ResourceName.CPU] == 24000
    return first + [plain(s.cache.quotas["gpu-pool"]),
                    P.QP.QuotaProfile(name="x", quota_name="y")
                    .effective_tree_id(), P.QP.UNBOUNDED]


CASES = {f.__name__: f for f in (
    h_constant_and_orders, h_decay_and_unknown, h_seeded_bank,
    s_prod_reclaimable, r_no_samples, r_peaks_become_status,
    r_selector_and_dedup, r_unmatched_pods, r_fresh_controller_keeps_ready,
    r_preseeded_gains_ready, r_deposed_publish_is_fenced,
    r_right_sized_from_usage, r_ready_recommendations, n_collect_policy,
    q_profile_controller)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_reference(case):
    assert CASES[case](PORT) == CASES[case](REF)


def test_predict_server_and_checkpoint_match_reference(tmp_path):
    assert s_server(PORT, tmp_path) == s_server(REF, tmp_path)
    # each package reads the other's checkpoint
    for a, b in ((PORT, REF), (REF, PORT)):
        path = str(tmp_path / f"{a.root}.json")
        reader, writer = b.PS.PeakPredictServer(), a.PS.PeakPredictServer()
        assert reader.load_checkpoint(path) and writer.load_checkpoint(path)
        assert reader.cpu.state() == writer.cpu.state()
        assert reader.peak("pod/p") == writer.peak("pod/p")
