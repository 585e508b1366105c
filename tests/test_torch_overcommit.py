"""The port's overcommit (``ops/overcommit.py``) and noderesource
controller (``manager/noderesource.py``) against the JAX package, on the
CPU, bit for bit.

Every case of the reference's ``tests/test_manager.py`` overcommit
classes runs here as one case of a parametrised test per class: the same
inputs go through both packages, the outputs must be equal, and the
reference's own expectations must hold for both. Seeded worlds
(``testing.colocation_world_spec``) add dangling rows, LSE pods, stale
metrics and per-node overrides, and carry the reference's lowered arrays
into the port's ``_overcommit_step`` through ``convert.overcommit_*``.
"""

import types as pytypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import koordinator_tpu.apis.extension as ref_ext
import koordinator_tpu.apis.types as ref_types
import koordinator_tpu.manager.noderesource as ref_nr
import koordinator_tpu.manager.sloconfig as ref_slo
import koordinator_tpu.ops.overcommit as ref_oc
import koordinator_tpu_torch.apis.extension as ext
import koordinator_tpu_torch.apis.types as ttypes
import koordinator_tpu_torch.manager.noderesource as nr
import koordinator_tpu_torch.manager.sloconfig as slo
import koordinator_tpu_torch.ops.overcommit as oc
from koordinator_tpu_torch import convert, testing

R = ext.ResourceName
CPU, MEM = R.CPU, R.MEMORY
BCPU, BMEM = R.BATCH_CPU, R.BATCH_MEMORY
NR = ext.NUM_RESOURCES
POLICY = oc.CalculatePolicy

REF = pytypes.SimpleNamespace(types=ref_types, ext=ref_ext, nr=ref_nr,
                              slo=ref_slo, kw={})
PORT = pytypes.SimpleNamespace(types=ttypes, ext=ext, nr=nr, slo=slo,
                               kw={"device": "cpu"})


# -- the ops: numpy inputs for both packages ---------------------------------

def _params(cpu_pct=60, mem_pct=65, cpu_policy=POLICY.USAGE,
            mem_policy=POLICY.USAGE, mid_pct=100):
    reclaim = np.zeros(NR, np.int32)
    reclaim[CPU], reclaim[MEM] = cpu_pct, mem_pct
    mid = np.zeros(NR, np.int32)
    mid[CPU] = mid[MEM] = mid_pct
    return dict(reclaim_percent=reclaim, mid_threshold_percent=mid,
                cpu_policy=np.asarray(cpu_policy, np.int32),
                memory_policy=np.asarray(mem_policy, np.int32))


def _nodes(capacity, system=None, reserved=None, reclaimable=None,
           fresh=None):
    capacity = np.asarray(capacity, np.int32)
    z = np.zeros_like(capacity)
    return dict(
        capacity=capacity,
        system_used=np.asarray(system if system is not None else z, np.int32),
        reserved=np.asarray(reserved if reserved is not None else z,
                            np.int32),
        prod_reclaimable=np.asarray(
            reclaimable if reclaimable is not None else z, np.int32),
        metric_fresh=np.asarray(
            fresh if fresh is not None else np.ones(len(capacity), bool)))


def _pods(node_idx, req, usage, has_metric, is_hp=None, is_lse=None):
    p = len(node_idx)
    return dict(
        node_idx=np.array(node_idx, np.int32),
        req=np.array(req, np.int32), usage=np.array(usage, np.int32),
        has_metric=np.array(has_metric, bool),
        is_hp=np.array(is_hp if is_hp is not None else [True] * p, bool),
        is_lse=np.array(is_lse if is_lse is not None else [False] * p, bool),
        active=np.ones(p, bool))


def _vec(cpu=0, mem=0):
    v = np.zeros(NR, np.int64)
    v[CPU], v[MEM] = cpu, mem
    return v


def _ref_tuple(cls, d):
    return cls(**{k: jnp.asarray(v) for k, v in d.items()})


def _both_batch(nodes, pods, params):
    want = np.asarray(ref_oc.batch_allocatable(
        _ref_tuple(ref_oc.NodeOvercommitInputs, nodes),
        _ref_tuple(ref_oc.PodOvercommitInputs, pods),
        _ref_tuple(ref_oc.OvercommitParams, params)))
    got = oc.batch_allocatable(convert.overcommit_nodes(nodes, device="cpu"),
                               convert.overcommit_pods(pods, device="cpu"),
                               convert.overcommit_params(params, device="cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    return want


BATCH_CASES = {
    # cap 10000/10000, reclaim 60%/65%: margin 4000/3500
    "usage_policy_formula": (
        lambda: (_nodes([_vec(10000, 10000)], system=[_vec(1000, 500)]),
                 _pods([0], [_vec(3000, 2000)], [_vec(2000, 1000)], [True]),
                 _params()),
        lambda out: (out[0, BCPU] == 10000 - 4000 - 1000 - 2000
                     and out[0, BMEM] == 10000 - 3500 - 500 - 1000)),
    "system_used_maxed_with_reserved": (
        lambda: (_nodes([_vec(10000, 10000)], system=[_vec(500, 200)],
                        reserved=[_vec(1500, 800)]),
                 _pods([0], [_vec()], [_vec()], [True], is_hp=[False]),
                 _params()),
        lambda out: (out[0, BCPU] == 10000 - 4000 - 1500
                     and out[0, BMEM] == 10000 - 3500 - 800)),
    "no_metric_pod_counts_request": (
        lambda: (_nodes([_vec(10000, 10000)]),
                 _pods([0], [_vec(4000, 3000)], [_vec()], [False]),
                 _params()),
        lambda out: (out[0, BCPU] == 10000 - 4000 - 4000
                     and out[0, BMEM] == 10000 - 3500 - 3000)),
    "lse_pod_mixes_cpu_request_memory_usage": (
        lambda: (_nodes([_vec(10000, 10000)]),
                 _pods([0], [_vec(4000, 3000)], [_vec(1000, 1000)], [True],
                       is_lse=[True]),
                 _params()),
        lambda out: (out[0, BCPU] == 10000 - 4000 - 4000
                     and out[0, BMEM] == 10000 - 3500 - 1000)),
    "lp_pods_ignored": (
        lambda: (_nodes([_vec(10000, 10000)]),
                 _pods([0], [_vec(9000, 9000)], [_vec(9000, 9000)], [True],
                       is_hp=[False]),
                 _params()),
        lambda out: out[0, BCPU] == 6000 and out[0, BMEM] == 6500),
    "clamped_at_zero": (
        lambda: (_nodes([_vec(1000, 1000)], system=[_vec(900, 900)]),
                 _pods([0], [_vec(500, 500)], [_vec(500, 500)], [True]),
                 _params()),
        lambda out: out[0, BCPU] == 0 and out[0, BMEM] == 0),
    "max_usage_request_policy": (
        lambda: (_nodes([_vec(10000, 10000)]),
                 _pods([0], [_vec(3000, 1000)], [_vec(2000, 2000)], [True]),
                 _params(cpu_policy=POLICY.MAX_USAGE_REQUEST,
                         mem_policy=POLICY.MAX_USAGE_REQUEST)),
        lambda out: (out[0, BCPU] == 10000 - 4000 - 3000
                     and out[0, BMEM] == 10000 - 3500 - 2000)),
    "request_policy_memory": (
        lambda: (_nodes([_vec(10000, 10000)], system=[_vec(2000, 2000)],
                        reserved=[_vec(100, 100)]),
                 _pods([0], [_vec(3000, 1000)], [_vec(100, 100)], [True]),
                 _params(mem_policy=POLICY.REQUEST)),
        lambda out: (out[0, BMEM] == 10000 - 3500 - 100 - 1000
                     and out[0, BCPU] == 10000 - 4000 - 2000 - 100)),
    "degrade_zeroes_stale_nodes": (
        lambda: (_nodes([_vec(10000, 10000), _vec(10000, 10000)],
                        fresh=[True, False]),
                 _pods([0], [_vec()], [_vec()], [True], is_hp=[False]),
                 _params()),
        lambda out: (out[0, BCPU] == 6000 and out[1, BCPU] == 0
                     and out[1, BMEM] == 0)),
    "multi_node_segment_sum": (
        lambda: (_nodes([_vec(10000, 10000)] * 3),
                 _pods([0, 0, 2, -1], [_vec(1000, 500)] * 4,
                       [_vec(800, 400)] * 4, [True] * 4),
                 _params()),
        lambda out: (out[0, BCPU] == 6000 - 1600 and out[1, BCPU] == 6000
                     and out[2, BCPU] == 6000 - 800)),
    # the index_add_ of int32 rows wraps as the reference's segment_sum
    "segment_sum_wraps_int32": (
        lambda: (_nodes([_vec(10000, 10000)] * 2),
                 _pods([1, 1, 1, 0], [_vec(2 ** 30, 2 ** 30)] * 4,
                       [_vec(2 ** 30, 5)] * 4, [True] * 4),
                 _params()),
        lambda out: True),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batch_allocatable_matches_reference(case):
    build, expect = BATCH_CASES[case]
    assert expect(_both_batch(*build()))


MID_CASES = {
    "min_of_reclaimable_and_threshold": (
        lambda: (_nodes([_vec(10000, 10000)], reclaimable=[_vec(3000, 9000)]),
                 _params(mid_pct=50)),
        lambda out: (out[0, R.MID_CPU] == 3000
                     and out[0, R.MID_MEMORY] == 5000)),
    "degraded_zero": (
        lambda: (_nodes([_vec(10000, 10000)], reclaimable=[_vec(3000, 3000)],
                        fresh=[False]),
                 _params()),
        lambda out: out[0, R.MID_CPU] == 0),
}


@pytest.mark.parametrize("case", sorted(MID_CASES))
def test_mid_allocatable_matches_reference(case):
    build, expect = MID_CASES[case]
    nodes, params = build()
    want = np.asarray(ref_oc.mid_allocatable(
        _ref_tuple(ref_oc.NodeOvercommitInputs, nodes),
        _ref_tuple(ref_oc.OvercommitParams, params)))
    got = oc.mid_allocatable(convert.overcommit_nodes(nodes, device="cpu"),
                             convert.overcommit_params(params, device="cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert expect(want)


def _sync_inputs():
    old = np.zeros((3, NR), np.int32)
    new = np.zeros((3, NR), np.int32)
    old[0, BCPU], new[0, BCPU] = 1000, 1099   # 9.9% < 10%: no sync
    old[1, BCPU], new[1, BCPU] = 1000, 1101   # 10.1%: sync
    old[2, BCPU], new[2, BCPU] = 0, 1         # zero old, nonzero new
    return old, new


@pytest.mark.parametrize("threshold", ["scalar", "per_node"])
def test_needs_sync_matches_reference(threshold):
    old, new = _sync_inputs()
    thr = (np.asarray(10, np.int32) if threshold == "scalar"
           else np.full(3, 10, np.int32))
    want = np.asarray(ref_oc.needs_sync(jnp.asarray(old), jnp.asarray(new),
                                        jnp.asarray(thr)))
    got = oc.needs_sync(torch.as_tensor(old), torch.as_tensor(new),
                        torch.as_tensor(thr))
    np.testing.assert_array_equal(got.numpy(), want)
    assert list(want) == [False, True, True]


def test_percent_helpers_match_reference():
    from koordinator_tpu.ops.common import (
        mul_percent_floor as ref_mul,
        percent_exceeds as ref_exceeds,
    )
    from koordinator_tpu_torch.ops.common import (
        mul_percent_floor,
        percent_exceeds,
    )

    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** 31 - 1, 4000).astype(np.int32)
    pct = rng.integers(0, 101, 4000).astype(np.int32)
    diff = rng.integers(0, 2 ** 31 - 1, 4000).astype(np.int32)
    np.testing.assert_array_equal(
        mul_percent_floor(torch.as_tensor(x), torch.as_tensor(pct)).numpy(),
        np.asarray(ref_mul(jnp.asarray(x), jnp.asarray(pct))))
    np.testing.assert_array_equal(
        percent_exceeds(torch.as_tensor(diff), torch.as_tensor(x),
                        torch.as_tensor(pct)).numpy(),
        np.asarray(ref_exceeds(jnp.asarray(diff), jnp.asarray(x),
                               jnp.asarray(pct))))


# -- the controller: one scenario per reference case, run in both packages --

def _ints(res):
    return None if res is None else {int(k): v for k, v in res.items()}


def _record(updates, snap):
    """Everything a reconcile decides and writes, package-neutral."""
    return (
        [(u.node_name, _ints(u.allocatable), u.synced, u.degraded,
          dict(u.annotations), u.meta_synced) for u in updates],
        [(n.name, _ints(n.allocatable), dict(n.annotations),
          _ints(n.raw_allocatable)) for n in snap.nodes],
    )


def _base_snapshot(P, now=1000.0):
    t, r = P.types, P.ext.ResourceName
    pod = t.PodSpec("p0", requests={r.CPU: 3000, r.MEMORY: 2000},
                    priority=9500, node_name="n0", qos=P.ext.QoSClass.LS)
    metric = t.NodeMetric("n0", sys_usage={r.CPU: 1000, r.MEMORY: 500},
                          pod_usages={pod.uid: {r.CPU: 2000, r.MEMORY: 1000}},
                          update_time=now - 60)
    return t.ClusterSnapshot(
        nodes=[t.NodeSpec("n0", allocatable={r.CPU: 10000, r.MEMORY: 10000})],
        pods=[pod], node_metrics={"n0": metric}, now=now)


def _ctrl(P, config=None):
    return P.nr.NodeResourceController(config, **P.kw)


def _disabled(P):
    return P.slo.ColocationConfig(
        cluster_strategy=P.slo.ColocationStrategy(enable=False))


def sc_reconcile_end_to_end(P):
    snap = _base_snapshot(P)
    upds = _ctrl(P).reconcile_all(snap)
    assert len(upds) == 1 and upds[0].synced and not upds[0].degraded
    assert upds[0].allocatable[BCPU] == 10000 - 4000 - 1000 - 2000
    assert upds[0].allocatable[BMEM] == 10000 - 3500 - 500 - 1000
    assert snap.nodes[0].allocatable[BCPU] == upds[0].allocatable[BCPU]
    return [_record(upds, snap)]


def sc_degrade_on_stale_metric(P):
    snap = _base_snapshot(P)
    snap.node_metrics["n0"].update_time = snap.now - 16 * 60
    upds = _ctrl(P).reconcile_all(snap)
    assert upds[0].degraded and upds[0].allocatable[BCPU] == 0
    return [_record(upds, snap)]


def sc_dangling_pod_metric_subtracted(P):
    snap = _base_snapshot(P)
    snap.node_metrics["n0"].pod_usages["ghost"] = {CPU: 500, MEM: 250}
    upds = _ctrl(P).reconcile_all(snap)
    assert upds[0].allocatable[BCPU] == 10000 - 4000 - 1000 - 2000 - 500
    return [_record(upds, snap)]


def sc_dangling_lp_pod_ignored(P):
    snap = _base_snapshot(P)
    snap.node_metrics["n0"].pod_usages["ghost"] = {CPU: 500}
    snap.node_metrics["n0"].pod_priority_class["ghost"] = (
        P.ext.PriorityClass.BATCH)
    upds = _ctrl(P).reconcile_all(snap)
    assert upds[0].allocatable[BCPU] == 10000 - 4000 - 1000 - 2000
    return [_record(upds, snap)]


def sc_node_reservation_annotation(P):
    snap = _base_snapshot(P)
    snap.nodes[0].annotations[P.ext.ANNOTATION_NODE_RESERVATION] = (
        '{"cpu": 1500, "memory": 800}')
    upds = _ctrl(P).reconcile_all(snap)
    assert upds[0].allocatable[BCPU] == 10000 - 4000 - 1500 - 2000
    return [_record(upds, snap)]


def sc_no_sync_when_diff_small(P):
    snap = _base_snapshot(P)
    ctrl = _ctrl(P)
    out = [_record(ctrl.reconcile_all(snap), snap)]
    assert out[0][0][0][2]
    snap.node_metrics["n0"].sys_usage[P.ext.ResourceName.CPU] = 1010
    out.append(_record(ctrl.reconcile_all(snap), snap))
    assert not out[1][0][0][2]
    return out


def sc_periodic_force_sync_after_time_threshold(P):
    snap = _base_snapshot(P)
    ctrl = _ctrl(P)
    out = [_record(ctrl.reconcile_all(snap), snap)]
    snap.node_metrics["n0"].sys_usage[P.ext.ResourceName.CPU] = 1010
    out.append(_record(ctrl.reconcile_all(snap), snap))
    snap.now += 301
    snap.node_metrics["n0"].update_time = snap.now - 60
    out.append(_record(ctrl.reconcile_all(snap), snap))
    assert [o[0][0][2] for o in out] == [True, False, True]
    return out


def sc_disabled_strategy_no_sync(P):
    snap = _base_snapshot(P)
    upds = _ctrl(P, _disabled(P)).reconcile_all(snap)
    assert not upds[0].synced
    return [_record(upds, snap)]


def sc_disabling_withdraws_batch_resources(P):
    snap = _base_snapshot(P)
    out = [_record(_ctrl(P).reconcile_all(snap), snap)]
    assert snap.nodes[0].allocatable[BCPU] > 0
    upds = _ctrl(P, _disabled(P)).reconcile_all(snap)
    assert upds[0].synced and upds[0].allocatable[BCPU] == 0
    assert snap.nodes[0].allocatable[BCPU] == 0
    return out + [_record(upds, snap)]


def sc_annotation_only_change_sets_meta_synced(P):
    snap = _base_snapshot(P)
    ctrl = _ctrl(P)
    out = [_record(ctrl.reconcile_all(snap), snap)]
    snap.nodes[0].annotations[P.ext.ANNOTATION_CPU_NORMALIZATION_RATIO] = "1.5"
    upds = ctrl.reconcile_all(snap)
    assert upds[0].meta_synced
    out.append(_record(upds, snap))
    upds = ctrl.reconcile_all(snap)
    assert not upds[0].meta_synced
    return out + [_record(upds, snap)]


def sc_huge_memory_node_no_overflow(P):
    t, r = P.types, P.ext.ResourceName
    big = 64 * 1024 * 1024  # MiB: capacity * percent would wrap int32
    snap = t.ClusterSnapshot(
        nodes=[t.NodeSpec("n0", allocatable={r.CPU: 10000, r.MEMORY: big})],
        pods=[],
        node_metrics={"n0": t.NodeMetric(
            "n0", prod_reclaimable={r.MEMORY: big // 2}, update_time=940.0)},
        now=1000.0)
    upds = _ctrl(P).reconcile_all(snap)
    assert upds[0].allocatable[BMEM] == big - (big * 35) // 100
    assert upds[0].allocatable[R.MID_MEMORY] == big // 2
    return [_record(upds, snap)]


def sc_nonfinite_normalization_ratio_ignored(P):
    out = []
    for bad in ("inf", "1e400", "nan", "1e15"):
        snap = _base_snapshot(P)
        snap.nodes[0].annotations[
            P.ext.ANNOTATION_CPU_NORMALIZATION_RATIO] = bad
        out.append(_record(_ctrl(P).reconcile_all(snap), snap))
        assert snap.nodes[0].allocatable[CPU] == 10000
    return out


def sc_cpu_normalization_amplifies(P):
    snap = _base_snapshot(P)
    key = P.ext.ANNOTATION_CPU_NORMALIZATION_RATIO
    snap.nodes[0].annotations[key] = "1.5"
    ctrl = _ctrl(P)
    out = [_record(ctrl.reconcile_all(snap), snap)]
    assert snap.nodes[0].allocatable[CPU] == 15000
    assert snap.nodes[0].raw_allocatable[CPU] == 10000
    out.append(_record(ctrl.reconcile_all(snap), snap))
    assert snap.nodes[0].allocatable[CPU] == 15000
    del snap.nodes[0].annotations[key]
    out.append(_record(ctrl.reconcile_all(snap), snap))
    assert snap.nodes[0].allocatable[CPU] == 10000
    assert snap.nodes[0].raw_allocatable is None
    return out


def sc_malformed_reservation_annotation_ignored(P):
    out = []
    for bad in ('{"cpu": "1500m"}', "[]", "not-json"):
        snap = _base_snapshot(P)
        snap.nodes[0].annotations[P.ext.ANNOTATION_NODE_RESERVATION] = bad
        upds = _ctrl(P).reconcile_all(snap)
        assert upds[0].allocatable[BCPU] == 10000 - 4000 - 1000 - 2000
        out.append(_record(upds, snap))
    return out


def sc_overrange_reclaim_percent_clamped(P):
    snap = _base_snapshot(P)
    cfg = P.slo.ColocationConfig(
        cluster_strategy=P.slo.ColocationStrategy(enable=True),
        node_strategies=[P.slo.NodeStrategySelector(
            match_labels={},
            overrides={"cpu_reclaim_threshold_percent": 150})])
    upds = _ctrl(P, cfg).reconcile_all(snap)
    assert upds[0].allocatable[BCPU] == 10000 - 0 - 1000 - 2000
    return [_record(upds, snap)]


def sc_per_node_strategy_override(P):
    t, r = P.types, P.ext.ResourceName
    snap = _base_snapshot(P)
    snap.nodes.append(t.NodeSpec("n1", allocatable={r.CPU: 10000,
                                                    r.MEMORY: 10000},
                                 labels={"pool": "aggressive"}))
    snap.node_metrics["n1"] = t.NodeMetric(
        "n1", sys_usage={r.CPU: 1000, r.MEMORY: 500},
        update_time=snap.now - 60)
    cfg = P.slo.ColocationConfig(
        cluster_strategy=P.slo.ColocationStrategy(enable=True),
        node_strategies=[P.slo.NodeStrategySelector(
            match_labels={"pool": "aggressive"},
            overrides={"cpu_reclaim_threshold_percent": 80})])
    upds = _ctrl(P, cfg).reconcile_all(snap)
    assert upds[0].allocatable[BCPU] == 10000 - 4000 - 1000 - 2000
    assert upds[1].allocatable[BCPU] == 10000 - 2000 - 1000
    return [_record(upds, snap)]


def sc_partial_colocation_override_preserves_cluster_strategy(P):
    cfg = P.slo.ColocationConfig(
        cluster_strategy=P.slo.ColocationStrategy(
            enable=True, cpu_reclaim_threshold_percent=70),
        node_strategies=[P.slo.NodeStrategySelector(
            match_labels={"pool": "x"},
            overrides={"memory_reclaim_threshold_percent": 50})])
    s = cfg.strategy_for_node({"pool": "x"})
    assert s.enable and s.cpu_reclaim_threshold_percent == 70
    assert s.memory_reclaim_threshold_percent == 50
    return [vars(s)]


def sc_strategy_from_dict_and_validity(P):
    strategy = P.slo.ColocationStrategy.from_dict(
        {"enable": True, "cpu_reclaim_threshold_percent": 70, "unknown": 1})
    bad = P.slo.merge_overrides(strategy, {"degrade_time_minutes": 0})
    assert strategy.is_valid() and not bad.is_valid()
    assert strategy.degrade_time_minutes == 15  # the base is not mutated
    return [vars(strategy), vars(bad)]


def sc_be_host_app_usage_excluded_from_system_used(P):
    t, r = P.types, P.ext.ResourceName
    out, batch = [], []
    for with_be_app in (False, True):
        metric = t.NodeMetric(
            node_name="n0", node_usage={r.CPU: 10000, r.MEMORY: 8192},
            sys_usage={r.CPU: 4000, r.MEMORY: 2048}, update_time=100.0)
        if with_be_app:
            metric.host_app_usages["miner"] = {r.CPU: 3000, r.MEMORY: 1024}
            metric.host_app_qos["miner"] = P.ext.QoSClass.BE
        snap = t.ClusterSnapshot(
            nodes=[t.NodeSpec(name="n0", allocatable={r.CPU: 32000,
                                                      r.MEMORY: 65536})],
            node_metrics={"n0": metric}, now=110.0)
        out.append(_record(_ctrl(P).reconcile_all(snap), snap))
        batch.append(snap.nodes[0].allocatable.get(r.BATCH_CPU, 0))
    assert batch[1] == batch[0] + 3000
    return out


CONTROLLER_CASES = {name[3:]: fn for name, fn in globals().items()
                    if name.startswith("sc_")}


@pytest.mark.parametrize("case", sorted(CONTROLLER_CASES))
def test_controller_matches_reference(case):
    scenario = CONTROLLER_CASES[case]
    assert scenario(PORT) == scenario(REF)


# -- seeded worlds -----------------------------------------------------------

def _world(seed):
    return testing.colocation_world_spec(
        seed=seed, n_nodes=40, pods_per_node=5, n_dangling=30, n_pending=0,
        override_frac=0.2, normalized_frac=0.1, reserving_frac=0.1,
        stale_frac=0.15, host_app_frac=0.2)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_world_matches_reference(seed, monkeypatch):
    """Two reconciles (the world, then 10% of its metrics changed) in both
    packages: equal updates and nodes; and the reference's lowered arrays
    of each reconcile, carried into the port's ``_overcommit_step``
    through ``convert.overcommit_*``, give the reference's step."""
    spec = _world(seed)
    changes = testing.colocation_metric_changes(spec, frac=0.1, seed=seed)
    captured = []
    step = ref_nr._overcommit_step

    def capture(*args):
        out = step(*args)
        captured.append((args, out))
        return out

    monkeypatch.setattr(ref_nr, "_overcommit_step", capture)
    records = []
    for P in (PORT, REF):
        snap = testing.colocation_snapshot(spec, P.types)
        ctrl = _ctrl(P, testing.colocation_config(spec, P.slo))
        rec = [_record(ctrl.reconcile_all(snap), snap)]
        for m in changes:
            snap.node_metrics[m["node_name"]] = testing.colocation_metric(
                m, P.types)
        snap.now += 60.0
        rec.append(_record(ctrl.reconcile_all(snap), snap))
        records.append(rec)
    assert records[0] == records[1]
    synced = [sum(u[2] for u in r[0]) for r in records[0]]
    assert synced[0] > synced[1] > 0, synced
    assert any(u[3] for u in records[0][0][0])   # some node degraded

    assert len(captured) == 2
    for (nodes, pods, params, old, thr, enabled), (alloc, sync) in captured:
        def np_dict(t):
            return {k: np.asarray(v) for k, v in t._asdict().items()}

        got_alloc, got_sync = nr._overcommit_step(
            convert.overcommit_nodes(np_dict(nodes), device="cpu"),
            convert.overcommit_pods(np_dict(pods), device="cpu"),
            convert.overcommit_params(np_dict(params), device="cpu"),
            torch.as_tensor(np.array(old)), torch.as_tensor(np.array(thr)),
            torch.as_tensor(np.array(enabled)))
        assert got_alloc.dtype == torch.int32
        np.testing.assert_array_equal(got_alloc.numpy(), np.asarray(alloc))
        np.testing.assert_array_equal(got_sync.numpy(), np.asarray(sync))


def test_controller_default_device_is_cuda():
    """No device: ``cuda``, which raises where there is none."""
    if torch.cuda.is_available():
        assert nr.NodeResourceController().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            nr.NodeResourceController()
