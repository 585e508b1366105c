"""The slice as a whole: the port's ``PlacementModel(device="cpu")``
against the JAX package's ``PlacementModel(use_pallas=False)`` on the
same seeded snapshot, built with each package's types, reservations
included (placements, waiting pods, the consumption records and every
mutated ``ReservationSpec``)."""

import pytest

from koordinator_tpu.apis import types as jtypes
from koordinator_tpu.apis.extension import ResourceName as JResourceName
from koordinator_tpu.models.placement import PlacementModel as JPlacementModel
from koordinator_tpu_torch import testing
from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import ResourceName as TResourceName
from koordinator_tpu_torch.models.placement import PlacementModel


def _both(spec):
    return (testing.build_snapshot(spec, jtypes, JResourceName),
            testing.build_snapshot(spec, ttypes, TResourceName))


@pytest.mark.parametrize("seed,selectors,solver", [
    (0, False, "kernel"),
    (1, False, "kernel"),
    # node selectors and host ports: host extras rows, which the kernel
    # takes in compact form (the case keeps the id it had when they took
    # the loop)
    pytest.param(2, True, "kernel", id="2-True-loop"),
])
def test_schedule_matches_reference(seed, selectors, solver):
    jsnap, tsnap = _both(testing.mixed_snapshot_spec(seed, selectors=selectors))
    want = JPlacementModel(use_pallas=False).schedule(jsnap)
    model = PlacementModel(device="cpu")
    got = model.schedule(tsnap)
    assert model.last_solver == solver
    assert dict(got) == dict(want)
    assert got.waiting == want.waiting
    placed = [u for u, n in got.items() if n is not None]
    assert placed and len(placed) < len(got)
    # the unknown-gang pods are blocked, gang outcomes are non-trivial
    ghost = {p.uid for p in tsnap.pending_pods if p.gang == "ghost"}
    assert ghost and all(got[u] is None for u in ghost)
    assert set(model.last_timings) == {"lower_s", "stage_s", "solve_s"}


def test_schedule_non_kernel_config_matches_reference():
    """prod-usage thresholds keep a solve off the kernel."""
    spec = testing.mixed_snapshot_spec(3)
    jsnap, tsnap = _both(spec)
    prod = {JResourceName.CPU: 60}
    want = JPlacementModel(use_pallas=False,
                           prod_usage_thresholds=prod).schedule(jsnap)
    model = PlacementModel(device="cpu",
                           prod_usage_thresholds={TResourceName.CPU: 60})
    got = model.schedule(tsnap)
    assert model.last_solver == "loop"
    assert dict(got) == dict(want) and got.waiting == want.waiting


def _consumption(records):
    return {uid: (name, [int(x) for x in delta])
            for uid, (name, delta) in records.items()}


def _specs(snap):
    return [(r.name, {int(k): v for k, v in r.allocated.items()},
             list(r.allocated_pod_uids), r.state.value)
            for r in snap.reservations]


def assert_same_schedule(got, want, tsnap, jsnap):
    assert dict(got) == dict(want)
    assert got.waiting == want.waiting
    assert _consumption(got.resv_allocs) == _consumption(want.resv_allocs)
    assert (_consumption(got.resv_committed)
            == _consumption(want.resv_committed))
    assert _specs(tsnap) == _specs(jsnap)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_schedule_with_reservations_matches_reference(seed):
    spec = testing.mixed_snapshot_spec(seed, reservations=True)
    jsnap, tsnap = _both(spec)
    before = _specs(tsnap)
    want = JPlacementModel(use_pallas=False).schedule(jsnap)
    model = PlacementModel(device="cpu")
    got = model.schedule(tsnap)
    assert model.last_solver == "kernel"
    assert_same_schedule(got, want, tsnap, jsnap)
    assert got.resv_committed and _specs(tsnap) != before
    # the reservation probe pod never consumes a reservation
    assert "__resv__probe" in got
    assert all("__resv__probe" not in r.allocated_pod_uids
               for r in tsnap.reservations)


def test_unsafe_reservation_table_takes_the_loop():
    """A reservation whose credit could overflow the packed key's score
    budget sends the solve to the loop, which still equals the
    reference."""
    spec = testing.mixed_snapshot_spec(4, reservations=True)
    small = min(spec["nodes"], key=lambda n: n["alloc"][int(TResourceName.CPU)])
    cpu = small["alloc"][int(TResourceName.CPU)] * 330
    spec["reservations"].append(dict(
        spec["reservations"][0], name="huge", node_name=small["name"],
        requests={int(TResourceName.CPU): cpu}, owner_labels={"app": "a0"}))
    jsnap, tsnap = _both(spec)
    want = JPlacementModel(use_pallas=False).schedule(jsnap)
    model = PlacementModel(device="cpu")
    got = model.schedule(tsnap)
    assert model.last_solver == "loop"
    assert_same_schedule(got, want, tsnap, jsnap)


def test_empty_and_unported_inputs():
    model = PlacementModel(device="cpu")
    out = model.schedule(ttypes.ClusterSnapshot(pending_pods=[
        ttypes.PodSpec(name="p", requests={TResourceName.CPU: 100})]))
    assert out == {"default/p": None}
    assert model.schedule(ttypes.ClusterSnapshot()) == {}
    # a reservation holding a whole node: only its owner gets in, and
    # consumes it
    cpu = TResourceName.CPU
    resv = ttypes.ReservationSpec(
        name="r", requests={cpu: 4000}, owner_labels={"app": "x"},
        node_name="n0", state=ttypes.ReservationState.AVAILABLE)
    snap = ttypes.ClusterSnapshot(
        nodes=[ttypes.NodeSpec(name="n0", allocatable={cpu: 4000})],
        pending_pods=[
            ttypes.PodSpec(name="other", requests={cpu: 1000}, priority=9),
            ttypes.PodSpec(name="owner", requests={cpu: 1000},
                           labels={"app": "x"})],
        reservations=[resv])
    out = model.schedule(snap)
    assert out == {"default/other": None, "default/owner": "n0"}
    assert resv.allocated == {cpu: 1000}
    assert resv.state == ttypes.ReservationState.SUCCEEDED  # allocate_once
    assert out.resv_committed["default/owner"][0] == "r"
    # a real fine-grained manager is accepted: with no topology, devices
    # or specials it changes nothing
    from koordinator_tpu_torch.models.finegrained import FineGrained
    from koordinator_tpu_torch.scheduler.plugins.deviceshare import (
        DeviceSharePlugin,
    )
    from koordinator_tpu_torch.scheduler.plugins.nodenumaresource import (
        NodeNUMAResourcePlugin,
    )
    from koordinator_tpu_torch.scheduler.plugins.nodeports import (
        NodePortsPlugin,
    )

    fine = FineGrained(NodeNUMAResourcePlugin(), DeviceSharePlugin(),
                       NodePortsPlugin())
    fine_model = PlacementModel(device="cpu", fine=fine)
    assert fine_model.fine is fine
    resv.state = ttypes.ReservationState.AVAILABLE
    resv.allocated, resv.allocated_pod_uids = {}, []
    assert fine_model.schedule(snap) == out
    assert fine_model.last_solver == "kernel"


def test_add_reservations_builder():
    """The reservation wave ``chip_smoke.py`` drives, at a small size:
    every reservation on its own node and owned (gang label or one solo
    pod's uid), some consumed through the kernel path, and the node
    holds left after the solve within capacity."""
    snap = testing.add_pending_wave(
        testing.churn_world(60, seed=42)[0], 300, n_quota=6, n_gangs=10,
        gang_size=8, seed=7)
    snap = testing.add_reservations(snap, 10, 6, seed=11)
    resvs = snap.reservations
    assert len({r.node_name for r in resvs}) == 16
    assert all(r.owner_labels or len(r.owner_pod_uids) == 1 for r in resvs)
    model = PlacementModel(device="cpu")
    got = model.schedule(snap)
    assert model.last_solver == "kernel"
    assert got.resv_committed or got.resv_allocs
    booked = {u for r in resvs for u in r.allocated_pod_uids}
    assert booked == set(got.resv_committed) | set(got.resv_allocs)
