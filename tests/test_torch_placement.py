"""The slice as a whole: the port's ``PlacementModel(device="cpu")``
against the JAX package's ``PlacementModel(use_pallas=False)`` on the
same seeded snapshot, built with each package's types."""

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
    (2, True, "loop"),   # node selectors and host ports: the extras route
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


def test_empty_and_unported_inputs():
    model = PlacementModel(device="cpu")
    out = model.schedule(ttypes.ClusterSnapshot(pending_pods=[
        ttypes.PodSpec(name="p", requests={TResourceName.CPU: 100})]))
    assert out == {"default/p": None}
    assert model.schedule(ttypes.ClusterSnapshot()) == {}
    with pytest.raises(NotImplementedError):
        model.schedule(ttypes.ClusterSnapshot(reservations=[object()]))
    with pytest.raises(NotImplementedError):
        PlacementModel(device="cpu", fine=object())
