"""The port's ``ServingSLOController`` (``control/slo.py``) against the JAX
package's: seeded observation streams, with non-zero padding waste among
them, through both packages' pure ``step`` give equal decision records,
and both packages' ``replay_decisions`` reproduce them; bench config #20
(the SLO convergence) cut small on a fake clock through both packages'
streaming loops gives equal decision logs and observation rings (the
reference is given a device stub with padding waste 0 through its own
``device=`` argument; the port reads its own ``DEVICE_OBS``); the knob
state is published fenced over the bus and adopted on promotion; and
``build_slo_controller`` wires the debug service and the flight payload.
"""

import random
from types import SimpleNamespace

import pytest

from koordinator_tpu.apis import types as jtypes
from koordinator_tpu.apis.extension import ResourceName as JResourceName
from koordinator_tpu.client import bus as jbus
from koordinator_tpu.client import wiring as jwiring
from koordinator_tpu.control import slo as jslo
from koordinator_tpu.models.placement import PlacementModel as JPlacementModel
from koordinator_tpu.obs import timeline as jtimeline
from koordinator_tpu.scheduler import Scheduler as JScheduler
from koordinator_tpu.scheduler import streaming as jstreaming
from koordinator_tpu.testing import arrivals as jarrivals
from koordinator_tpu_torch.apis import types as ttypes
from koordinator_tpu_torch.apis.extension import ResourceName as TResourceName
from koordinator_tpu_torch.client import bus as tbus
from koordinator_tpu_torch.client import wiring as twiring
from koordinator_tpu_torch.client.leaderelection import LeaderElector
from koordinator_tpu_torch.cmd.scheduler import (
    SchedulerConfig,
    build_slo_controller,
)
from koordinator_tpu_torch.control import slo
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.obs import timeline as ttimeline
from koordinator_tpu_torch.obs.flight import FLIGHT
from koordinator_tpu_torch.scheduler import streaming as tstreaming
from koordinator_tpu_torch.scheduler.scheduler import Scheduler
from koordinator_tpu_torch.testing import arrivals as tarrivals
from koordinator_tpu_torch.testing.failure_domain import SLO, slo_arm

LANES = ("system", "ls", "be")


def observation_stream(seed, n=160):
    """Seeded observations a live loop could record: lane p99s around
    their targets, shed bursts, padding waste (often past the
    threshold), and knobs that follow the decisions the policy made."""
    rng = random.Random(seed)
    knobs = {"watermark": 64, "lane_deadline_s": [0.002, 0.016, 0.050],
             "capacity": 4096}
    out = []
    now = 100.0
    for seq in range(1, n + 1):
        now = round(now + rng.choice((0.05, 0.1, 0.3, 0.5)), 6)
        lanes = {}
        for lane in LANES:
            if rng.random() < 0.15:
                continue
            count = rng.randrange(0, 40)
            p99 = None if count == 0 else round(rng.uniform(0.0005, 0.02), 6)
            shed = {}
            if rng.random() < 0.1:
                shed["capacity"] = rng.randrange(1, 5)
            if rng.random() < 0.05:
                shed["deadline"] = 1
            lanes[lane] = {"count": count, "p99_s": p99, "shed": shed}
        out.append({
            "seq": seq, "now": now, "window_s": 0.4, "lanes": lanes,
            "knobs": {"watermark": knobs["watermark"],
                      "lane_deadline_s": list(knobs["lane_deadline_s"]),
                      "capacity": knobs["capacity"]},
            "device": {"compiles": rng.randrange(0, 3),
                       "padding_waste": rng.choice((0.0, 0.2, 0.7, 0.9))},
        })
        yield out[-1]


def drive_policy(module, seed, spec_kw):
    ctl = module.ServingSLOController(
        loop=None, spec=module.SLOSpec(**spec_kw), log=lambda *a: None,
        **SLO.ctl_params)
    ctl._relax_cap = {"system": 0.002, "ls": 0.016, "be": 0.050}
    decisions, observations = [], []
    gen = observation_stream(seed)
    knobs = None
    for obs in gen:
        if knobs is not None:
            obs["knobs"] = knobs
        observations.append(obs)
        d = ctl.step(obs)
        knobs = {"watermark": obs["knobs"]["watermark"],
                 "lane_deadline_s": list(obs["knobs"]["lane_deadline_s"]),
                 "capacity": obs["knobs"]["capacity"]}
        if d is not None:
            decisions.append(d)
            if d["knob"] == "deadline":
                knobs["lane_deadline_s"][LANES.index(d["lane"])] = d["new"]
            else:
                knobs[d["knob"]] = d["new"]
    return decisions, observations, ctl.status()["policy"]


@pytest.mark.parametrize("seed, spec_kw", [
    (1, dict(ls=0.005)), (2, dict(ls=0.005, be=0.02)),
    (3, dict(system=0.001, ls=0.008)), (4, dict()), (5, dict(be=0.01))])
def test_step_matches_reference_on_seeded_streams(seed, spec_kw):
    port, port_obs, port_policy = drive_policy(slo, seed, spec_kw)
    ref, ref_obs, ref_policy = drive_policy(jslo, seed, spec_kw)
    assert port_obs == ref_obs
    assert port == ref
    assert len(port) >= 5
    assert port_policy == ref_policy
    # both packages' replays reproduce the log from the observations
    for module in (slo, jslo):
        assert module.replay_decisions(
            module.SLOSpec(**spec_kw), port_obs,
            base_deadlines=(0.002, 0.016, 0.050),
            **SLO.ctl_params) == port


def test_padding_waste_signal_fires_on_a_nonzero_waste():
    """The port's own observations carry 0.0, but ``step`` is the
    reference's policy on any observation."""
    knobs = {"watermark": 64, "lane_deadline_s": [0.002, 0.016, 0.050],
             "capacity": 4096}
    obs = {"seq": 1, "now": 1.0, "window_s": 0.4, "lanes": {},
           "knobs": knobs, "device": {"compiles": 0, "padding_waste": 0.8}}
    got = [module.ServingSLOController(
        loop=None, spec=module.SLOSpec(), log=lambda *a: None).step(obs)
        for module in (slo, jslo)]
    assert got[0] == got[1]
    assert got[0]["signal"] == "padding-waste" and got[0]["new"] == 128


class _StubDevice:
    def mark(self):
        return {"compiles": 0}

    def padding_waste(self):
        return 0.0


PORT_NS = SimpleNamespace(
    APIServer=tbus.APIServer, Kind=tbus.Kind,
    wire_scheduler=twiring.wire_scheduler, Scheduler=Scheduler,
    model=lambda: PlacementModel(device="cpu"),
    PodTimelines=ttimeline.PodTimelines,
    StreamingLoop=tstreaming.StreamingLoop,
    StreamingConfig=tstreaming.StreamingConfig,
    ServingSLOController=slo.ServingSLOController, SLOSpec=slo.SLOSpec,
    NodeSpec=ttypes.NodeSpec, NodeMetric=ttypes.NodeMetric,
    ResourceName=TResourceName, trace_pods=tarrivals.trace_pods)
REF_NS = SimpleNamespace(
    APIServer=jbus.APIServer, Kind=jbus.Kind,
    wire_scheduler=jwiring.wire_scheduler, Scheduler=JScheduler,
    model=lambda: JPlacementModel(use_pallas=False),
    PodTimelines=jtimeline.PodTimelines,
    StreamingLoop=jstreaming.StreamingLoop,
    StreamingConfig=jstreaming.StreamingConfig,
    ServingSLOController=jslo.ServingSLOController, SLOSpec=jslo.SLOSpec,
    NodeSpec=jtypes.NodeSpec, NodeMetric=jtypes.NodeMetric,
    ResourceName=JResourceName, trace_pods=jarrivals.trace_pods)


@pytest.mark.parametrize("regime", ["low", "saturating"])
def test_slo_convergence_cut_small_matches_reference(regime):
    """Config #20 cut small (a 1.6 s trace at 60 pods/s) through both
    packages' streaming loops on a fake clock."""
    def trace(arrivals):
        return arrivals.regime_scale(arrivals.diurnal_trace(
            seed=SLO.seed, duration_s=1.6, rate_pods_per_s=60.0), regime)

    port = slo_arm(PORT_NS, trace(tarrivals), SLO.start_deadlines, True)
    ref = slo_arm(REF_NS, trace(jarrivals), SLO.start_deadlines, True,
                  device=_StubDevice())
    assert port["observations"] == ref["observations"]
    assert port["decisions_log"] == ref["decisions_log"]
    assert 1 <= port["decisions"] <= 12
    for key in ("final_ls_p99_s", "rounds", "bound", "submitted",
                "capacity_shed", "final_lane_deadline_s"):
        assert port[key] == ref[key], key
    assert slo.replay_decisions(
        slo.SLOSpec(ls=SLO.target_s), port["observations"],
        base_deadlines=SLO.start_deadlines,
        **SLO.ctl_params) == port["decisions_log"]
    assert all(o["device"] == {"compiles": 0, "padding_waste": 0.0}
               for o in port["observations"])


def _loop(bus, clock):
    sched = Scheduler(model=PlacementModel(device="cpu"))
    twiring.wire_scheduler(bus, sched)
    return tstreaming.StreamingLoop(
        sched, apply_fn=lambda pod: bus.apply(tbus.Kind.POD, pod.uid, pod),
        delete_fn=lambda uid: bus.delete(tbus.Kind.POD, uid),
        config=tstreaming.StreamingConfig(
            watermark=64, lane_deadline_s=SLO.start_deadlines),
        clock=lambda: clock[0], now_fn=lambda: clock[0],
        log=lambda *a: None)


def test_fenced_publish_and_adoption_on_promotion():
    clock = [100.0]
    bus = tbus.APIServer()
    elector = LeaderElector(bus, "koord-scheduler", "leader")
    assert elector.tick(clock[0])
    loop = _loop(bus, clock)
    logs = []
    ctl = slo.ServingSLOController(
        loop, slo.SLOSpec(ls=0.005), bus=bus, elector=elector,
        clock=lambda: clock[0], log=logs.append, **SLO.ctl_params)
    knobs = {"watermark": 64, "lane_deadline_s": [0.002, 0.016, 0.050],
             "capacity": 4096}
    try:
        ctl._publish_state(7)
        state = bus.get(tbus.Kind.NODE_SLO, slo.DEFAULT_STATE_NAME)
        assert state["seq"] == 7 and state["knobs"] == knobs
        # a deposed leader's late publish is fenced and dropped
        rival = LeaderElector(bus, "koord-scheduler", "rival")
        assert rival.tick(clock[0] + 100.0)
        ctl._publish_state(8)
        assert bus.get(tbus.Kind.NODE_SLO,
                       slo.DEFAULT_STATE_NAME)["seq"] == 7
        assert any("fenced" in line for line in logs)
        # the promoted standby adopts the published knobs
        standby = slo.ServingSLOController(
            _loop(bus, clock), slo.SLOSpec(ls=0.005), bus=bus,
            clock=lambda: clock[0], log=lambda *a: None)
        bus.apply(tbus.Kind.NODE_SLO, slo.DEFAULT_STATE_NAME, {
            "seq": 9, "knobs": {"watermark": 16,
                                "lane_deadline_s": [0.001, 0.004, 0.025],
                                "capacity": 8192}})
        assert standby.on_promoted() is True
        cfg = standby._loop.cfg
        assert (cfg.watermark, cfg.lane_deadline_s, cfg.capacity) == \
            (16, (0.001, 0.004, 0.025), 8192)
        assert standby.status()["adopted_state"] is True
        standby._loop.stop()
    finally:
        loop.stop()


def test_build_slo_controller_wires_debug_and_flight():
    clock = [100.0]
    bus = tbus.APIServer()
    loop = _loop(bus, clock)
    try:
        assert build_slo_controller(loop, bus, SchedulerConfig()) is None
        ctl = build_slo_controller(
            loop, bus, SchedulerConfig(slo_ls="p99=0.005",
                                       slo_cooldown_s=0.5))
        assert ctl.spec.ls == 0.005 and ctl.cooldown_s == 0.5
        assert loop.scheduler.services.query("slo")["spec"]["ls"] == 0.005
        assert "slo" in FLIGHT._payload_hooks
    finally:
        FLIGHT.unregister_payload("slo")
        loop.stop()
