"""The port's descheduler loop over the bus, the NodeSLO renderer and a
composed control plane, against the JAX package's, on the CPU.

``DeschedulerLoop`` (``client/wiring.py``): the reference's bus cases
(a migration reserved on the idle node by the placement solver and
placed there by the scheduler's next round; an assumed pod's quota
released by the eviction; completed jobs pruned; a direct evictor
refused), the fenced rollback of a deposed loop (the bus objects and the
evictor's jobs as the reference leaves them), and the reservation probe
held against the reference's on a seeded world. The NodeSLO renderer
(``manager/nodeslo.py``) with overrides and extenders, and
``ManagerLoop(nodeslo=)`` publishing, re-publishing only what changed,
and fenced. Then one composed run: a scheduler, a manager with the
NodeSLO renderer and a descheduler on one bus, round for round against
the reference's composition (without the koordlet and the webhook,
which are not ported)."""

import dataclasses
import importlib

import numpy as np
import pytest

from test_torch_colocation import PORT, REF

CPU, MEM = 0, 1


def mods(P):
    m = lambda name: importlib.import_module(f"{P.root}.{name}")  # noqa: E731
    return dict(fw=m("descheduler.framework"), la=m("descheduler.loadaware"),
                nodeslo=m("manager.nodeslo"), slo=m("manager.sloconfig"),
                cmd=m("cmd.descheduler"),
                model=m("models.placement").PlacementModel)


def place_model(P):
    M = mods(P)["model"]
    return M(device="cpu") if P.port else M(use_pallas=False)


def descheduler(P, low=30, high=70, evictor=None):
    M = mods(P)
    plugin = M["la"].LowNodeLoad(M["la"].LowNodeLoadArgs(node_pools=[
        M["la"].NodePool(low_thresholds={P.X.ResourceName.CPU: low},
                         high_thresholds={P.X.ResourceName.CPU: high})]))
    return M["fw"].Descheduler(
        profiles=[M["fw"].Profile(name="d", balance_plugins=[plugin])],
        evictor=evictor or M["fw"].MigrationEvictor())


def wire(P, bus, desched, elector=None):
    return P.wiring.wire_descheduler(bus, desched,
                                     place_model=place_model(P),
                                     elector=elector)


def both(case):
    got, want = case(PORT), case(REF)
    assert got == want
    return got


def hot_cold(P, bus):
    bus.apply(P.Kind.NODE, "hot", P.node("hot", cpu=10000))
    bus.apply(P.Kind.NODE, "cold", P.node("cold", cpu=10000))
    bus.apply(P.Kind.NODE_METRIC, "hot", P.metric(
        "hot", usage={CPU: 9000}, update_time=100.0))
    bus.apply(P.Kind.NODE_METRIC, "cold", P.metric(
        "cold", usage={CPU: 200}, update_time=100.0))


def bus_state(P, bus):
    """The bus's pods, reservations and jobs as plain data."""
    return (
        sorted((k, p.node_name) for k, p in bus.list(P.Kind.POD).items()),
        sorted((k, r.node_name, r.state.name, list(r.owner_pod_uids))
               for k, r in bus.list(P.Kind.RESERVATION).items()),
        sorted((k, j.pod_uid, j.phase.name, j.reservation_name)
               for k, j in bus.list(P.Kind.MIGRATION_JOB).items()),
    )


# -- DeschedulerLoop -------------------------------------------------------------

def test_descheduler_loop_migrates_over_bus():
    """An overloaded node's pod gets a MigrationJob and a reservation on
    the idle node (the solver's choice), flows back through the bus into
    the scheduler's queue, and the next round places it there."""
    def case(P):
        bus = P.bus()
        sched = P.scheduler()
        P.wiring.wire_scheduler(bus, sched)
        hot_cold(P, bus)
        bus.apply(P.Kind.POD, "default/heavy", P.pod(
            "heavy", {CPU: 4000}, node_name="hot"))
        loop = wire(P, bus, descheduler(P))
        migrated = loop.run_once(now=110.0)
        assert migrated == ["default/heavy"]
        state = bus_state(P, bus)
        assert [r[1] for r in state[1]] == ["cold"]
        out = sched.schedule_pending(now=120.0)
        assert out["default/heavy"] == "cold"
        return migrated, state, dict(out), bus_state(P, bus)

    both(case)


def test_migration_releases_assigned_state_and_prunes():
    """Migrating a scheduler-assumed pod releases its quota used through
    the bus delete, completed jobs leave the dedup window, and a direct
    evictor is refused."""
    def case(P):
        bus = P.bus()
        s = P.scheduler()
        P.wiring.wire_scheduler(bus, s)
        hot_cold(P, bus)
        bus.apply(P.Kind.NODE_METRIC, "hot", P.metric(
            "hot", usage={CPU: 1000}, update_time=100.0))
        bus.apply(P.Kind.QUOTA, "t", P.T.QuotaSpec(
            name="t", min=P.res({CPU: 1000}), max=P.res({CPU: 9000})))
        bus.apply(P.Kind.NODE, "cold", P.node("cold", cpu=10000,
                                              unschedulable=True))
        bus.apply(P.Kind.POD, "default/heavy", P.pod(
            "heavy", {CPU: 4000}, quota="t"))
        out0 = s.schedule_pending(now=100.0)
        assert out0["default/heavy"] == "hot"
        assert s.quota_manager.quotas["t"].used[CPU] == 4000
        bus.apply(P.Kind.NODE_METRIC, "hot", P.metric(
            "hot", usage={CPU: 9000}, update_time=105.0))
        bus.apply(P.Kind.NODE, "cold", P.node("cold", cpu=10000))
        loop = wire(P, bus, descheduler(P))
        loop.run_once(now=110.0)
        assert s.quota_manager.quotas["t"].used[CPU] == 0
        assert "default/heavy" in s.cache.pending
        assert loop.descheduler.evictor.jobs == []
        with pytest.raises(TypeError):
            wire(P, bus, descheduler(P, evictor=mods(P)["fw"].DirectEvictor()))
        return bus_state(P, bus)

    both(case)


def test_deposed_descheduler_rolls_back_in_place():
    """A loop deposed between its reconcile and its mutations raises
    FencingError with nothing applied: the shared victim object's node is
    restored, the advanced jobs are discarded, and the bus holds what
    the reference's holds."""
    def case(P):
        bus = P.bus()
        ea = P.le.LeaderElector(bus, "koord-descheduler", "a")
        eb = P.le.LeaderElector(bus, "koord-descheduler", "b")
        loop = wire(P, bus, descheduler(P), elector=ea)
        hot_cold(P, bus)
        victim = P.pod("heavy", {CPU: 4000}, node_name="hot")
        bus.apply(P.Kind.POD, "default/heavy", victim)
        ea.tick(0.0)
        eb.tick(20.0)
        with pytest.raises(P.le.FencingError):
            loop.run_once(now=110.0)
        assert bus.get(P.Kind.POD, "default/heavy") is victim
        assert victim.node_name == "hot"
        assert not bus.list(P.Kind.MIGRATION_JOB)
        assert not bus.list(P.Kind.RESERVATION)
        assert loop.descheduler.evictor.jobs == []
        return bus_state(P, bus)

    both(case)


def test_snapshot_from_bus_with_reservations():
    def case(P):
        bus = P.bus()
        hot_cold(P, bus)
        bus.apply(P.Kind.RESERVATION, "r", P.T.ReservationSpec(
            name="r", node_name="cold", state=P.T.ReservationState.AVAILABLE))
        bus.apply(P.Kind.POD, "default/w", P.pod(
            "w", {CPU: 1}, node_name="hot", waiting_permit=True))
        bus.apply(P.Kind.POD, "default/b", P.pod("b", {CPU: 1},
                                                 node_name="cold"))
        plain = P.wiring.snapshot_from_bus(bus, 1.0)
        with_resv = P.wiring.snapshot_from_bus(bus, 1.0,
                                               with_reservations=True)
        return ([p.uid for p in plain.pods], len(plain.reservations),
                [r.name for r in with_resv.reservations])

    assert both(case) == (["default/b"], 0, ["r"])


def probe_world(P, seed):
    """A seeded 40-node world with bound pods, metrics, a few Available
    reservations and node-reservation annotations."""
    rng = np.random.default_rng(seed)
    nodes, pods = [], []
    for i in range(40):
        ann = {}
        if i % 7 == 0:
            ann[P.X.ANNOTATION_NODE_RESERVATION] = (
                '{"resources": {"cpu": "2"}}')
        nodes.append(P.node(f"n{i}", cpu=16000, mem=32768, annotations=ann))
        for j in range(int(rng.integers(0, 5))):
            pods.append(P.pod(f"p{i}-{j}", {CPU: int(rng.integers(500, 3000)),
                                            MEM: int(rng.integers(256, 4096))},
                              node_name=f"n{i}"))
    metrics = {n.name: P.metric(n.name, usage={
        CPU: int(rng.integers(0, 12000)), MEM: int(rng.integers(0, 20000))},
        update_time=100.0) for n in nodes}
    resv = [P.T.ReservationSpec(
        name=f"r{k}", node_name=f"n{3 * k}", requests=P.res({CPU: 4000}),
        allocatable=P.res({CPU: 4000}),
        state=P.T.ReservationState.AVAILABLE) for k in range(4)]
    return P.T.ClusterSnapshot(nodes=nodes, pods=pods, node_metrics=metrics,
                               reservations=resv, now=110.0)


def test_reservation_probe_matches_reference():
    """``_place`` on a seeded world: each probe (a victim's shape, and a
    requests-only reservation) lands on the reference's node."""
    def case(P):
        snap = probe_world(P, seed=9)
        loop = wire(P, P.bus(), descheduler(P))
        got = []
        for k, victim in enumerate(snap.pods[::5]):
            resv = P.T.ReservationSpec(
                name=f"reserve-{k}", requests=dict(victim.requests),
                owner_pod_uids=[victim.uid])
            got.append(loop._place(snap, resv))
        got.append(loop._place(snap, P.T.ReservationSpec(
            name="bare", requests=P.res({CPU: 9000, MEM: 1024}))))
        return got

    got = both(case)
    assert all(node is not None for node in got)


# -- NodeSLO -------------------------------------------------------------------------

def render_case(P):
    M = mods(P)
    cluster = M["slo"].default_node_slo_spec()
    cluster.resource_used_threshold_with_be.memory_evict_threshold_percent = 80

    def ext(name, labels, spec):
        spec.extensions["x"] = name

    ctrl = M["nodeslo"].NodeSLOController(
        cluster_spec=cluster,
        overrides=[
            M["nodeslo"].NodeSLOOverride(
                match_labels={"pool": "be"},
                overrides={"resource_used_threshold_with_be": {
                    "enable": True, "cpu_suppress_threshold_percent": 50}}),
            M["nodeslo"].NodeSLOOverride(
                match_labels={"burst": "on"},
                overrides={"cpu_burst_strategy": {"policy": "auto"},
                           "system_strategy": {"min_free_kbytes_factor": 7}}),
        ],
        extenders=[ext])
    specs = ctrl.reconcile_all([("n0", {"pool": "be"}),
                                ("n1", {"pool": "ls"}),
                                ("n2", {"pool": "be", "burst": "on"})])
    t = specs["n0"].resource_used_threshold_with_be
    assert t.enable and t.cpu_suppress_threshold_percent == 50
    assert t.memory_evict_threshold_percent == 80
    assert specs["n1"].resource_used_threshold_with_be.enable is False
    assert specs["n2"].cpu_burst_strategy.policy == "auto"
    assert ctrl.cluster_spec.extensions == {}
    default = M["slo"].default_node_slo_spec()
    assert default.resource_qos_strategy.be.cpu.group_identity == -1
    assert default.resource_qos_strategy.be.resctrl.cat_range_end_percent == 30
    assert default.cpu_burst_strategy.cpu_burst_percent == 1000
    return {n: dataclasses.asdict(s) for n, s in specs.items()}


def test_nodeslo_render_overrides_and_extenders():
    both(render_case)


def test_manager_loop_publishes_nodeslo_and_fences():
    """Each node's render lands on the bus; an unchanged render is not
    re-applied; a deposed manager's NodeSLO write raises."""
    def case(P):
        M = mods(P)
        bus = P.bus()
        ctrl = M["nodeslo"].NodeSLOController(overrides=[
            M["nodeslo"].NodeSLOOverride(
                match_labels={"pool": "be"},
                overrides={"resource_used_threshold_with_be": {
                    "enable": True}})])
        ea = P.le.LeaderElector(bus, "koord-manager", "a")
        eb = P.le.LeaderElector(bus, "koord-manager", "b")
        loop = P.wiring.ManagerLoop(bus, P.controller(), elector=ea,
                                    nodeslo=ctrl)
        events = []
        bus.watch(P.Kind.NODE_SLO, lambda e, n, o: events.append((e.value, n)))
        bus.apply(P.Kind.NODE, "n0", P.node("n0", labels={"pool": "be"}))
        bus.apply(P.Kind.NODE, "n1", P.node("n1"))
        ea.tick(0.0)
        loop.reconcile(now=1.0)
        loop.reconcile(now=2.0)   # nothing changed: no re-apply
        bus.apply(P.Kind.NODE, "n1", P.node("n1", labels={"pool": "be"}))
        loop.reconcile(now=3.0)
        enabled = {n: bus.get(P.Kind.NODE_SLO, n)
                   .resource_used_threshold_with_be.enable
                   for n in ("n0", "n1")}
        bus.apply(P.Kind.NODE, "n1", P.node("n1"))
        eb.tick(20.0)
        with pytest.raises(P.le.FencingError):
            loop.reconcile(now=21.0)
        return events, enabled

    events, enabled = both(case)
    assert events == [("ADDED", "n0"), ("ADDED", "n1"), ("MODIFIED", "n1")]
    assert enabled == {"n0": True, "n1": True}


# -- the binary's wiring ---------------------------------------------------------

def test_build_descheduler_and_gates():
    def case(P):
        cmd = mods(P)["cmd"]
        d = cmd.build_descheduler(cmd.DeschedulerConfig(high_cpu_percent=70))
        pool = d.profiles[0].balance_plugins[0].args.node_pools[0]
        off = cmd.build_descheduler(cmd.DeschedulerConfig(
            feature_gates="MigrationController=false,AnomalyDetection=false"))
        off_pool = off.profiles[0].balance_plugins[0].args.node_pools[0]
        with pytest.raises(KeyError, match="NoSuchGate"):
            cmd.build_descheduler(cmd.DeschedulerConfig(
                feature_gates="NoSuchGate=true"))
        return (int(pool.high_thresholds[P.X.ResourceName.CPU]),
                int(pool.low_thresholds[P.X.ResourceName.CPU]),
                pool.consecutive_abnormalities, type(d.evictor).__name__,
                d.evictor.limiter.max_per_node, d.descheduling_interval,
                off_pool.consecutive_abnormalities,
                type(off.evictor).__name__,
                sorted(cmd.DESCHEDULER_GATES.as_dict().items()))

    got = both(case)
    assert got[:4] == (70, 45, 3, "MigrationEvictor")
    assert got[6:8] == (1, "DirectEvictor")


# -- the composed control plane ------------------------------------------------

NODES = 10
HOT = ("n0", "n1")


def composed(P, rounds=4, seed=21):
    """A scheduler, a manager (colocation on, the NodeSLO renderer) and a
    descheduler (anomaly debounce 1) on one bus, seeded: two hot nodes
    hold four 3,000 mCPU pods each, every round re-reports each node's
    usage (110% of its requests on the hot nodes, 40% elsewhere) and
    submits a few pods. Returns every round's record."""
    M = mods(P)
    rng = np.random.default_rng(seed)
    bus = P.bus()
    sched = P.scheduler()
    P.wiring.wire_scheduler(bus, sched)
    manager = P.wiring.ManagerLoop(
        bus, P.controller(P.slo.ColocationConfig(
            cluster_strategy=P.slo.ColocationStrategy(enable=True))),
        nodeslo=M["nodeslo"].NodeSLOController(overrides=[
            M["nodeslo"].NodeSLOOverride(
                match_labels={"pool": "hot"},
                overrides={"resource_used_threshold_with_be": {
                    "enable": True}})]))
    desched = M["cmd"].build_descheduler(M["cmd"].DeschedulerConfig(
        anomaly_condition_count=1))
    loop = P.wiring.wire_descheduler(bus, desched, place_model=place_model(P))
    for i in range(NODES):
        name = f"n{i}"
        labels = {"pool": "hot"} if name in HOT else {}
        bus.apply(P.Kind.NODE, name, P.node(name, cpu=16000, mem=65536,
                                            labels=labels))
        count = 4 if name in HOT else 1
        for j in range(count):
            cpu = 3000 if name in HOT else int(rng.integers(500, 1500))
            pod = P.pod(f"{name}-b{j}", {CPU: cpu, MEM: 1024},
                        node_name=name)
            bus.apply(P.Kind.POD, pod.uid, pod)
    records = []
    for r in range(rounds):
        now = 100.0 + 10.0 * r
        load = {}
        for pod in bus.list(P.Kind.POD).values():
            if pod.node_name is not None:
                load[pod.node_name] = (load.get(pod.node_name, 0)
                                       + pod.requests[P.X.ResourceName.CPU])
        for i in range(NODES):
            name = f"n{i}"
            share = 1.1 if name in HOT else 0.4
            bus.apply(P.Kind.NODE_METRIC, name, P.metric(
                name, usage={CPU: int(load.get(name, 0) * share),
                             MEM: 4096}, update_time=now))
        synced = manager.reconcile(now=now)
        for j in range(3):
            pod = P.pod(f"r{r}-{j}", {CPU: int(rng.integers(300, 2500)),
                                      MEM: int(rng.integers(256, 4096))})
            bus.apply(P.Kind.POD, pod.uid, pod)
        out = sched.schedule_pending(now=now)
        migrated = loop.run_once(now=now + 1.0)
        records.append(dict(
            synced=synced, placed=sorted(out.items()), migrated=migrated,
            bus=bus_state(P, bus),
            slo=sorted((n, s.resource_used_threshold_with_be.enable)
                       for n, s in bus.list(P.Kind.NODE_SLO).items()),
            batch=sorted((n, int(node.allocatable.get(
                P.X.ResourceName.BATCH_CPU, 0)))
                for n, node in bus.list(P.Kind.NODE).items())))
    return records


def test_composed_control_plane_round_for_round():
    records = both(composed)
    migrated = [uid for rec in records for uid in rec["migrated"]]
    assert len(migrated) >= 2, migrated
    # the scheduler placed each migrated pod on its reservation's node
    final = dict(records[-1]["bus"][0])
    reserved = {owners[0]: node for _, node, _, owners in records[-1]["bus"][1]
                if owners}
    for uid in migrated:
        assert final[uid] == reserved[uid], uid
    assert records[0]["slo"] == sorted((f"n{i}", f"n{i}" in HOT)
                                       for i in range(NODES))
