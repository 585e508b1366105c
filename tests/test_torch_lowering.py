"""The port's snapshot lowering against the JAX package's, field by field,
on one seeded snapshot spec built with each package's types."""

import numpy as np
import pytest

from koordinator_tpu.apis import types as jtypes
from koordinator_tpu.apis.extension import ResourceName as JResourceName
from koordinator_tpu.state import cluster as jcluster
from koordinator_tpu_torch import testing
from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import ResourceName as TResourceName
from koordinator_tpu_torch.state import cluster as tcluster


def _snapshots(seed):
    spec = testing.mixed_snapshot_spec(seed)
    return (testing.build_snapshot(spec, jtypes, JResourceName),
            testing.build_snapshot(spec, ttypes, TResourceName))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lower_nodes_matches(seed):
    jsnap, tsnap = _snapshots(seed)
    want = jcluster.lower_nodes(jsnap)
    got = tcluster.lower_nodes(tsnap)
    assert got.names == want.names
    for f in ("alloc", "used_req", "usage", "prod_usage", "est_extra",
              "prod_base", "metric_fresh", "schedulable"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    # the spec's edges are present: a stale metric, a node without one, an
    # unschedulable node, assigned-pod estimation, prod usage
    assert not got.metric_fresh[3] and not got.metric_fresh[2]
    assert not got.schedulable[1]
    assert got.est_extra.any() and got.prod_usage.any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lower_pending_pods_matches(seed):
    jsnap, tsnap = _snapshots(seed)
    names = sorted(q.name for q in tsnap.quotas.values())
    quota_index = {n: i for i, n in enumerate(names)}
    gang_index = {n: i for i, n in enumerate(sorted(tsnap.gangs))}
    kw = dict(quota_index=quota_index, gang_index=gang_index)
    want = jcluster.lower_pending_pods(jsnap.pending_pods, **kw)
    got = tcluster.lower_pending_pods(tsnap.pending_pods, **kw)
    assert got.uids == want.uids
    for f in ("req", "est", "qos", "prio_class", "priority", "is_prod",
              "is_daemonset", "non_preemptible", "quota_id", "gang_id"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.is_prod.any() and got.non_preemptible.any()
    assert (got.prio_class == 2).any()  # batch pods read batch resources


def test_estimate_pod_used_matches():
    spec = testing.mixed_snapshot_spec(5)
    for p in spec["assigned"] + spec["pending"]:
        jpod = testing.build_snapshot(
            {**spec, "pending": [p], "assigned": []}, jtypes,
            JResourceName).pending_pods[0]
        tpod = testing.build_snapshot(
            {**spec, "pending": [p], "assigned": []}, ttypes,
            TResourceName).pending_pods[0]
        want = jcluster.estimate_pod_used(jpod)
        got = tcluster.estimate_pod_used(tpod)
        assert {int(k): v for k, v in got.items()} == {
            int(k): v for k, v in want.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_lower_nodes_with_reservation_holds_matches(seed):
    """Available reservations hold their unallocated remainder in
    ``used_req``; other states, unbound and unknown-node ones hold
    nothing."""
    spec = testing.mixed_snapshot_spec(seed, reservations=True)
    jsnap = testing.build_snapshot(spec, jtypes, JResourceName)
    tsnap = testing.build_snapshot(spec, ttypes, TResourceName)
    want = jcluster.lower_nodes(jsnap)
    got = tcluster.lower_nodes(tsnap)
    np.testing.assert_array_equal(got.used_req, want.used_req)
    plain = tcluster.lower_nodes(testing.build_snapshot(
        {**spec, "reservations": []}, ttypes, TResourceName))
    assert (got.used_req >= plain.used_req).all()
    assert (got.used_req != plain.used_req).any()
