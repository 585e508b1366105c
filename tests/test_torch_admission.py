"""The port's admission gate, coalesced lanes and tenant lanes against the
reference's (``service/admission.py``, ``service/tenancy.py``) on the same
seeded requests: lane solves bit-identical (exact), batching keys
byte-identical, and the gate's outcomes equal in the same scenarios (a
stubbed solo solve and an explicit clock; every wait bounded)."""

import dataclasses
import threading

import numpy as np
import pytest

from koordinator_tpu.service import admission as ref_adm
from koordinator_tpu.service import codec as ref_codec
from koordinator_tpu.service import tenancy as ref_ten
from koordinator_tpu_torch import testing
from koordinator_tpu_torch.service import admission, codec, tenancy

WAIT_S = 10.0
PKGS = {"port": (codec, admission, tenancy),
        "ref": (ref_codec, ref_adm, ref_ten)}


def same_responses(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for f in dataclasses.fields(w):
            a, b = getattr(g, f.name), getattr(w, f.name)
            if b is None or isinstance(b, str):
                assert a == b if isinstance(b, str) else a is None, f.name
            else:
                assert np.asarray(a).dtype == np.asarray(b).dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)


def coalesced_groups(k, seed=0):
    """K plain requests on one base, of unequal pod counts (<= 16)."""
    base = testing.service_request_groups("plain", 32, 16, seed=seed)
    rng = np.random.default_rng(seed + 1)
    out = []
    for i in range(k):
        p = int(rng.integers(1, 17))
        pods = {f: v[rng.permutation(16)[:p]] for f, v in base["pods"].items()}
        out.append(dict(base, pods=pods))
    return out


@pytest.mark.parametrize("want_state", [False, True])
@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_solve_coalesced_matches_reference(k, want_state):
    groups = coalesced_groups(k, seed=k)
    got = admission.solve_coalesced(
        [codec.SolveRequest(**g) for g in groups], want_state=want_state,
        device="cpu")
    want = ref_adm.solve_coalesced(
        [ref_codec.SolveRequest(**g) for g in groups], want_state=want_state)
    same_responses(got, want)


def tenant_groups(prod_threshold=False):
    """Three tenants: own worlds of 32, 20 and 27 nodes, own resource
    weights and thresholds, 16, 9 and 12 pods."""
    out = []
    for i, (n, p) in enumerate(((32, 16), (20, 9), (27, 12))):
        g = testing.service_request_groups("plain", n, p, seed=10 + i)
        g["params"] = dict(g["params"])
        g["params"]["weights"] = g["params"]["weights"] * (i + 1)
        g["params"]["thresholds"] = g["params"]["thresholds"] - 10 * i
        out.append(g)
    if prod_threshold:   # a lane the kernel does not take: all on the loop
        out[1]["params"]["prod_thresholds"] = out[1]["params"]["thresholds"]
    return out


@pytest.mark.parametrize("prod_threshold", [False, True])
def test_solve_tenant_lanes_matches_reference(prod_threshold):
    groups = tenant_groups(prod_threshold)
    got = tenancy.solve_tenant_lanes(
        [codec.SolveRequest(**g) for g in groups], want_state=True,
        device="cpu")
    want = ref_ten.solve_tenant_lanes(
        [ref_codec.SolveRequest(**g) for g in groups], want_state=True)
    same_responses(got, want)


def test_batching_keys_and_fair_share_match_reference():
    plain = testing.service_request_groups("plain", 32, 16, seed=2)
    tagged = dict(plain, admission={
        "tenant": np.frombuffer(b"team/a\n\"x", np.uint8)})
    for groups in (plain, tagged,
                   testing.service_request_groups("resv", seed=2)):
        ours, theirs = (codec.SolveRequest(**groups),
                        ref_codec.SolveRequest(**groups))
        assert tenancy.shape_bucket_key(ours) == ref_ten.shape_bucket_key(
            theirs)
        assert admission.coalesce_key(ours) == ref_adm.coalesce_key(theirs)
        assert tenancy.request_tenant(ours) == ref_ten.request_tenant(theirs)
        assert tenancy.plain_request(ours) == ref_ten.plain_request(theirs)
    assert tenancy.request_tenant(codec.SolveRequest(**tagged)) == "team_a__x"
    rng = np.random.default_rng(3)
    for _ in range(20):
        weights = {f"t{i}": float(w) for i, w in
                   enumerate(rng.uniform(0.1, 4, rng.integers(1, 6)))}
        cap = int(rng.integers(1, 200))
        assert tenancy.fair_share(cap, weights) == ref_ten.fair_share(
            cap, weights)
        cands = {t: [(t, j, int(rng.integers(1, 50)))
                     for j in range(rng.integers(0, 6))] for t in weights}
        args = (cands, lambda t: weights[t], int(rng.integers(1, 12)),
                int(rng.integers(10, 200)), lambda e: e[2],
                {t: int(rng.integers(0, 2)) for t in weights})
        assert tenancy.allocate_fair_lanes(*args) == ref_ten.allocate_fair_lanes(
            *args)
    for k in range(1, 40):
        assert tenancy.lane_bucket(k, 3) == ref_ten.lane_bucket(k, 3)
        assert tenancy.node_bucket(k * 37) == ref_ten.node_bucket(k * 37)
        assert admission.coalesce_pod_bucket(k) == ref_adm.coalesce_pod_bucket(k)


# -- the gate ---------------------------------------------------------------

class Scenario:
    """One gate of one package with a blocking stub solo solve and a
    clock the test moves."""

    def __init__(self, pkg, **cfg):
        self.codec, self.adm, self.ten = PKGS[pkg]
        self.now = [100.0]
        self.order = []
        self.entered = threading.Event()
        self.release = threading.Event()
        kwargs = {"device": "cpu"} if pkg == "port" else {}
        self.gate = self.adm.AdmissionGate(
            self.solve, self.adm.AdmissionConfig(coalesce_window_s=0.0,
                                                 **cfg),
            clock=lambda: self.now[0], **kwargs)
        self.entries = {}

    def solve(self, request, config, node_cache):
        name = bytes(request.quota["name"]).decode()
        self.order.append(name)
        self.entered.set()
        assert self.release.wait(WAIT_S)
        return self.codec.SolveResponse(assignments=np.zeros(1, np.int32))

    def submit(self, name, lane=1, tenant="default", deadline=None,
               groups=None):
        adm = {"lane": np.asarray(lane, np.int64),
               "tenant": self.ten.tenant_wire_value(tenant)}
        if deadline is not None:
            adm["deadline_s"] = np.asarray(deadline, np.float64)
        if groups is None:   # a request that never batches: solved solo
            groups = dict(testing.service_request_groups("plain", 8, 10),
                          quota={"name": np.frombuffer(name.encode(),
                                                       np.uint8)})
        req = self.codec.SolveRequest(**dict(groups, admission=adm))
        self.entries[name] = self.gate.submit(req, None)

    def block(self):
        """Submit a solo request that holds the executor."""
        self.submit("blocker", lane=0)
        assert self.entered.wait(WAIT_S)

    def outcomes(self):
        self.release.set()
        out = {}
        for name, e in self.entries.items():
            r = e.wait(WAIT_S)
            assert r is not None, name
            out[name] = r.error.split(":")[0] if r.error else "ok"
            e.delivered()
        stats = self.gate.stats()
        self.gate.shutdown(timeout=WAIT_S)
        assert not self.gate._thread.is_alive()
        return out, self.order, stats


def both(run):
    results = {}
    for pkg in PKGS:
        s = None
        try:
            s = run(pkg)
            results[pkg] = s.outcomes()
        finally:
            if s is not None:
                s.release.set()
                s.gate.shutdown(timeout=WAIT_S)
    assert results["port"][:2] == results["ref"][:2]
    return results["port"]


def test_gate_lane_priority():
    def run(pkg):
        s = Scenario(pkg, max_coalesce=1)
        s.block()
        for name, lane in (("be1", 2), ("ls1", 1), ("sys1", 0), ("be2", 2),
                           ("ls2", 1)):
            s.submit(name, lane)
        return s

    out, order, _ = both(run)
    assert order == ["blocker", "sys1", "ls1", "ls2", "be1", "be2"]
    assert set(out.values()) == {"ok"}


def test_gate_deadline_exceeded():
    def run(pkg):
        s = Scenario(pkg)
        s.block()
        s.submit("late", deadline=1.0)
        s.submit("fine", deadline=30.0)
        s.submit("none")
        s.now[0] += 2.0
        return s

    out, order, stats = both(run)
    assert out == {"blocker": "ok", "late": "deadline-exceeded",
                   "fine": "ok", "none": "ok"}
    assert stats["shed"]["deadline-exceeded"] == 1


def test_gate_sheds_best_effort_newest_first():
    def run(pkg):
        s = Scenario(pkg, capacity=3)
        s.block()
        for name, lane in (("be1", 2), ("be2", 2), ("ls1", 1), ("ls2", 1),
                           ("sys1", 0), ("be3", 2), ("ls3", 1)):
            s.submit(name, lane)
        return s

    out, order, stats = both(run)
    assert out["be2"] == out["be1"] == "overloaded"     # newest BE first
    assert out["be3"] == "overloaded"                   # outranks nothing
    assert out["ls3"] == "overloaded"
    assert out["ls1"] == out["ls2"] == out["sys1"] == "ok"
    assert order == ["blocker", "sys1", "ls1", "ls2"]
    assert stats["shed"]["overloaded"] == 4


def test_gate_fair_share_sheds_the_flooding_tenant():
    def run(pkg):
        s = Scenario(pkg, capacity=4)
        s.block()
        s.submit("b0", 2, tenant="quiet")    # at its share: protected
        for i in range(3):
            s.submit(f"a{i}", 1, tenant="flood")
        s.submit("a3", 0, tenant="flood")    # sheds its own newest, not b0
        s.submit("a4", 2, tenant="flood")    # outranks nothing: refused
        s.submit("c0", 1, tenant="third")    # b0 is not over its share
        return s

    out, order, stats = both(run)
    assert out == {"blocker": "ok", "b0": "ok", "a0": "ok", "a1": "ok",
                   "a2": "overloaded", "a3": "ok", "a4": "overloaded",
                   "c0": "overloaded"}
    assert order == ["blocker", "a3", "a0", "a1", "b0"]
    assert stats["tenants"]["flood"]["shed_overloaded"] == 2
    assert stats["tenants"]["quiet"]["shed_overloaded"] == 0


def test_gate_coalesce_ratio():
    groups = coalesced_groups(4, seed=9)

    def run(pkg):
        s = Scenario(pkg)
        s.block()
        for i, g in enumerate(groups):
            s.submit(f"c{i}", groups=g)
        return s

    out, order, stats = both(run)
    assert set(out.values()) == {"ok"}
    assert stats["batches_total"] == 2 and stats["requests_total"] == 5
    assert stats["coalesce_ratio"] == 2.5
    assert stats["coalesced_requests_total"] == 4


def test_gate_counts_its_solve_seconds():
    now = [5.0]

    def solve(request, config, node_cache):
        now[0] += 0.25
        return codec.SolveResponse(assignments=np.zeros(1, np.int32))

    gate = admission.AdmissionGate(
        solve, admission.AdmissionConfig(coalesce_window_s=0.0),
        clock=lambda: now[0], device="cpu")
    try:
        for _ in range(3):
            entry = gate.submit(codec.SolveRequest(
                **testing.service_request_groups("plain", 8, 10)), None)
            assert entry.wait(WAIT_S) is not None
            entry.delivered()
        assert gate.stats()["solve_seconds_total"] == 0.75
    finally:
        gate.shutdown(timeout=WAIT_S)
    assert not gate._thread.is_alive()
