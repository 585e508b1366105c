"""The port's descheduler against the JAX package's: ``LowNodeLoad`` on
the "host", "device" and "verify" backends (the device walk on the CPU,
its plain version) against the JAX plugin's host walk and the port's
``RebalanceOracle``, the JAX oracle against the port's, the refusal
fixpoint, dry-run proposals, multi-sweep debounce and deviation
thresholds, the plugin framework (``Descheduler.run_once`` with an
``EvictionLimiter``), the Kubernetes plugins and the migration
controller. Worlds come from ``koordinator_tpu_torch.testing``'s plain
specs, built with each package's types."""

import numpy as np
import pytest
import torch

from koordinator_tpu.apis import types as jtypes
from koordinator_tpu.apis.extension import ResourceName as JResourceName
from koordinator_tpu.descheduler import (
    Arbitrator as JArbitrator,
    LowNodeLoad as JLowNodeLoad,
    LowNodeLoadArgs as JArgs,
    MigrationController as JMigrationController,
    NodePool as JNodePool,
)
from koordinator_tpu.descheduler import framework as jfw
from koordinator_tpu.descheduler import kubernetes as jk8s
from koordinator_tpu.oracle.rebalance import RebalanceOracle as JOracle
from koordinator_tpu_torch import testing
from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import ResourceName as TResourceName
from koordinator_tpu_torch.descheduler import (
    Arbitrator,
    LowNodeLoad,
    LowNodeLoadArgs,
    MigrationController,
    NodePool,
)
from koordinator_tpu_torch.descheduler import framework as tfw
from koordinator_tpu_torch.descheduler import kubernetes as tk8s
from koordinator_tpu_torch.descheduler import loadaware
from koordinator_tpu_torch.descheduler.anomaly import State
from koordinator_tpu_torch.oracle.rebalance import RebalanceOracle

BACKENDS = ("host", "device", "verify")
J = (jtypes, JResourceName, JArgs, JNodePool, JLowNodeLoad, jfw)
T = (ttypes, TResourceName, LowNodeLoadArgs, NodePool, LowNodeLoad, tfw)


def _recording(fw):
    class Recording(fw.Evictor):
        """Approves every eviction and mutates nothing (the snapshot
        stays whole for the next run)."""

        def _do_evict(self, snapshot, pod, reason):
            return True

        @property
        def sequence(self):
            return [(p.node_name, p.uid) for p in self.evicted]

    return Recording


def _refusing(fw, every=3):
    class Refusing(fw.Evictor):
        """Refuses every ``every``-th eviction it is asked for."""

        asked = 0

        def _do_evict(self, snapshot, pod, reason):
            self.asked += 1
            return self.asked % every != 0

        @property
        def sequence(self):
            return [(p.node_name, p.uid) for p in self.evicted]

    return Refusing


def _pool(pkg, **kw):
    """A pool with the reference's default thresholds unless given."""
    return pkg[3](**kw)


def _args(pkg, pool_kw=None, **kw):
    return pkg[2](node_pools=[_pool(pkg, **(pool_kw or {}))], **kw)


def _port_args(backend, pool_kw=None, **kw):
    return _args(T, pool_kw, backend=backend,
                 device=None if backend == "host" else "cpu", **kw)


def _detectors(plugin):
    return {n: (d.abnormal_streak, d.normal_streak, d.state.value)
            for n, d in plugin.detectors.items()}


def _snapshots(spec):
    return (testing.build_snapshot(spec, jtypes, JResourceName),
            testing.build_snapshot(spec, ttypes, TResourceName))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", range(4))
def test_low_node_load_matches_reference(backend, seed):
    """Ordered eviction sequences equal the JAX plugin's host walk and
    the port's oracle, on random clusters (node fit on and off)."""
    jsnap, tsnap = _snapshots(testing.random_cluster_spec(
        np.random.default_rng(seed)))
    for node_fit in (True, False):
        want_ev = _recording(jfw)()
        JLowNodeLoad(_args(J, node_fit=node_fit)).balance(jsnap, want_ev)
        got_ev = _recording(tfw)()
        LowNodeLoad(_port_args(backend, node_fit=node_fit)).balance(tsnap,
                                                                    got_ev)
        assert got_ev.sequence == want_ev.sequence
        oracle = RebalanceOracle(_port_args("host", node_fit=node_fit))
        assert oracle.sweep(tsnap) == want_ev.sequence
    assert want_ev.sequence


@pytest.mark.parametrize("backend", BACKENDS)
def test_refusal_fixpoint_matches_reference(backend):
    """An evictor that refuses every third eviction: the device walk
    re-runs with the refused candidate blocked, resuming in place, and
    lands on the host walk's sequence."""
    for seed in (1, 5):
        jsnap, tsnap = _snapshots(testing.random_cluster_spec(
            np.random.default_rng(seed), n_nodes=30, n_pods=200))
        want_ev = _refusing(jfw)()
        JLowNodeLoad(_args(J)).balance(jsnap, want_ev)
        got_ev = _refusing(tfw)()
        LowNodeLoad(_port_args(backend)).balance(tsnap, got_ev)
        assert got_ev.sequence == want_ev.sequence
        assert got_ev.asked == want_ev.asked > 3


@pytest.mark.parametrize("backend", BACKENDS)
def test_dry_run_proposals_match_reference(backend):
    jsnap, tsnap = _snapshots(testing.random_cluster_spec(
        np.random.default_rng(2)))
    want = JLowNodeLoad(_args(J, dry_run=True))
    want.balance(jsnap, _recording(jfw)())
    got = LowNodeLoad(_port_args(backend, dry_run=True))
    evictor = _recording(tfw)()
    got.balance(tsnap, evictor)
    assert not evictor.evicted
    assert ([p.uid for p in got.last_proposals]
            == [p.uid for p in want.last_proposals])
    assert got.last_proposals


def _mutate(pkg, snapshot, rng):
    """Move every node's usage by a seeded step (both packages take the
    same draws)."""
    resource = pkg[1]
    for name in sorted(snapshot.node_metrics):
        metric = snapshot.node_metrics[name]
        for r in (resource.CPU, resource.MEMORY):
            metric.node_usage[r] = max(
                0, metric.node_usage.get(r, 0)
                + int(rng.integers(-6000, 6000)))


def _debounce_pool(pkg, deviation):
    """Two abnormal sweeps before a node counts; with ``deviation`` the
    thresholds are percent around the pool's average."""
    resource = pkg[1]
    kw = dict(consecutive_abnormalities=2)
    if deviation:
        kw.update(use_deviation_thresholds=True,
                  low_thresholds={resource.CPU: 10, resource.MEMORY: 10},
                  high_thresholds={resource.CPU: 10, resource.MEMORY: 5})
    return kw


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("deviation", (False, True))
def test_multi_sweep_debounce_matches_reference(backend, deviation):
    """Five sweeps in a row with ``consecutive_abnormalities=2`` and the
    usage moving between them: sequences and every detector's state equal
    the JAX plugin's after each sweep (a missed reset would only show on
    a later sweep)."""
    spec = testing.random_cluster_spec(np.random.default_rng(9), n_nodes=30,
                                       n_pods=180)
    jsnap, tsnap = _snapshots(spec)
    want_p = JLowNodeLoad(_args(J, _debounce_pool(J, deviation)))
    got_p = LowNodeLoad(_port_args(backend, _debounce_pool(T, deviation)))
    oracle = RebalanceOracle(_port_args("host", _debounce_pool(T, deviation)))
    jrng, trng = np.random.default_rng(4), np.random.default_rng(4)
    total = 0
    for sweep in range(5):
        if sweep:
            _mutate(J, jsnap, jrng)
            _mutate(T, tsnap, trng)
        want_ev, got_ev = _recording(jfw)(), _recording(tfw)()
        want_p.balance(jsnap, want_ev)
        got_p.balance(tsnap, got_ev)
        assert got_ev.sequence == want_ev.sequence, sweep
        assert oracle.sweep(tsnap) == want_ev.sequence, sweep
        assert _detectors(got_p) == _detectors(want_p), sweep
        total += len(want_ev.sequence)
    assert total > 0
    assert any(d.state == State.ANOMALY or d.abnormal_streak
               for d in got_p.detectors.values())


def test_oracle_matches_reference_oracle():
    """The port's copy of the scalar oracle equals the JAX package's,
    with a node selector splitting the pool in two and stale metrics."""
    for seed in range(3):
        spec = testing.random_cluster_spec(np.random.default_rng(seed + 20))
        for i, node in enumerate(spec["nodes"]):
            node["labels"] = {"tier": "a" if i % 2 else "b"}
        jsnap, tsnap = _snapshots(spec)
        pools = []
        for pkg in (J, T):
            pools.append([_pool(pkg, node_selector={"tier": "a"}),
                          _pool(pkg, consecutive_abnormalities=1)])
        want = JOracle(JArgs(node_pools=pools[0])).sweep(jsnap)
        got = RebalanceOracle(LowNodeLoadArgs(node_pools=pools[1])).sweep(
            tsnap)
        assert got == want


def test_verify_raises_on_a_diverging_stream(monkeypatch):
    """"verify" checks the device stream against the numpy replica
    before anything is applied and raises on a difference."""
    _, tsnap = _snapshots(testing.random_cluster_spec(
        np.random.default_rng(0)))
    replay = loadaware.replay_sweep_host

    def flipped(*args):
        propose, over, avail_ok = replay(*args)
        return ~propose, over, avail_ok

    monkeypatch.setattr(loadaware, "replay_sweep_host", flipped)
    evictor = _recording(tfw)()
    with pytest.raises(RuntimeError, match="propose stream diverged"):
        LowNodeLoad(_port_args("verify")).balance(tsnap, evictor)
    assert not evictor.evicted


def test_device_backend_needs_a_device(monkeypatch):
    """"device" and "verify" with no device given run on CUDA, and raise
    without one before any work; an unknown backend raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tsnap = _snapshots(testing.random_cluster_spec(
        np.random.default_rng(0)))
    for backend in ("device", "verify"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LowNodeLoad(_args(T, backend=backend)).balance(
                tsnap, _recording(tfw)())
    with pytest.raises(ValueError, match="unknown rebalance backend"):
        LowNodeLoad(_args(T, backend="gpu")).balance(tsnap,
                                                     _recording(tfw)())
    # the host walk needs no device
    LowNodeLoad(_args(T)).balance(tsnap, _recording(tfw)())


def _descheduler_run(pkg, k8s, spec, limiter_kw):
    types, resource, _, _, plugin_cls, fw = pkg
    snap = testing.build_snapshot(spec, types, resource)
    args = _port_args("device") if pkg is T else _args(pkg)
    profile = fw.Profile(
        name="p",
        deschedule_plugins=[k8s.RemovePodsViolatingNodeAffinity(),
                            k8s.RemovePodsHavingTooManyRestarts(
                                pod_restart_threshold=5),
                            k8s.RemoveDuplicates()],
        balance_plugins=[plugin_cls(args)])
    evictor = fw.DirectEvictor(fw.EvictionLimiter(**limiter_kw))
    sched = fw.Descheduler([profile], evictor, descheduling_interval=60.0)
    first = [p.uid for p in sched.maybe_run(snap, now=100.0)]
    skipped = sched.maybe_run(snap, now=130.0)
    second = [p.uid for p in sched.maybe_run(snap, now=161.0)]
    return first, skipped, second, sorted(p.uid for p in snap.pods)


@pytest.mark.parametrize("limiter_kw", [
    {}, {"max_per_cycle": 9}, {"max_per_node": 1},
    {"max_per_namespace": 4, "max_per_node": 2}])
def test_descheduler_run_once_matches_reference(limiter_kw):
    """``Descheduler.run_once`` (every Deschedule plugin, then every
    Balance plugin) with a ``DirectEvictor`` and an ``EvictionLimiter``:
    the same pods evicted in the same order, cycle by cycle, and the
    interval gate of ``maybe_run``."""
    spec = testing.random_cluster_spec(np.random.default_rng(13), n_nodes=20,
                                       n_pods=160)
    for j, pod in enumerate(spec["assigned"]):
        pod["owner"] = f"ReplicaSet/default/rs{j % 7}"
        pod["restart_count"] = j % 11
        if j % 17 == 0:
            pod["node_selector"] = {"zone": "x"}
    want = _descheduler_run(J, jk8s, spec, limiter_kw)
    got = _descheduler_run(T, tk8s, spec, limiter_kw)
    assert got == want
    assert got[0] and got[1] == []


def test_migration_evictor_and_controller_match_reference():
    """``MigrationEvictor`` emits one job per pod; the controller's
    arbitrator admits within its group limits, reserves a destination,
    then evicts; jobs past their TTL fail."""
    spec = testing.random_cluster_spec(np.random.default_rng(3), n_nodes=12,
                                       n_pods=60)
    for j, pod in enumerate(spec["assigned"]):
        pod["owner"] = f"ReplicaSet/default/rs{j % 4}"
    out = []
    for pkg, k8s, ctl, arb in ((J, jk8s, JMigrationController, JArbitrator),
                               (T, tk8s, MigrationController, Arbitrator)):
        types, resource, _, _, plugin_cls, fw = pkg
        snap = testing.build_snapshot(spec, types, resource)
        evictor = fw.MigrationEvictor()
        plugin_cls(_args(pkg)).balance(snap, evictor)
        for pod in snap.pods[:3]:   # a second request for a pod: deduped
            evictor.evict(snap, pod, reason="again")
        evictor.jobs[-1].create_time = -1000.0   # past its TTL
        nodes = [n.name for n in snap.nodes]
        controller = ctl(
            place_reservation=lambda s, r: nodes[len(s.reservations) % 5]
            if len(s.reservations) < 6 else None,
            arbitrator=arb(max_migrating_per_node=2,
                           max_migrating_per_workload=3))
        for t in range(3):
            snap.now = 120.0 + t
            controller.reconcile(snap, evictor.jobs)
        out.append(([(j.name, j.pod_uid, j.phase.value, j.reason,
                      j.reservation_name) for j in evictor.jobs],
                    sorted(p.uid for p in snap.pods),
                    [p.uid for p in snap.pending_pods],
                    [(r.name, r.node_name) for r in snap.reservations]))
    assert out[0] == out[1]
    assert any(j[2] == "Succeeded" for j in out[1][0])
    assert any(j[2] == "Failed" for j in out[1][0])
