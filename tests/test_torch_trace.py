"""The port's trace layer (``obs/trace.py``, ``obs/timeline.py``) and the
scheduler series it feeds, against the JAX package's, on the CPU.

The same call sequence drives both packages' ``SpanTracer`` and
``PodTimelines`` (with fake clocks): equal events, exports and stats.
Then one wired scenario (placements, a preemption, a defrag drain, a gang
WaitTime expiry, binds published over the bus) runs through both
packages' Schedulers: the span names and counts of each package's own
``TRACER`` and the eight scheduler series' values must be equal. The two
tracers and registries are separate objects; each side is read from its
own package."""

import importlib

import numpy as np
import pytest

from test_torch_colocation import PORT, REF, series_values, spans_of

CPU, MEM = 0, 1


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        self.t += 0.25
        return self.t


def _trace_sequence(trace_mod):
    tracer = trace_mod.SpanTracer(capacity=8, clock=FakeClock())
    rid = tracer.begin_round()
    tracer.mark_open(f"round:{rid}", round_id=rid)
    t0 = tracer.now()
    tracer.emit("begin_tick", cat="tick", t0=t0, track="coord",
                args={"pending": 3})
    tracer.instant("flip", cat="failover", track="coord")
    with tracer.span("ctx", cat="test"):
        pass
    marks = sorted(tracer.open_marks())
    stuck = [tracer.flag_stuck(f"round:{rid}"), tracer.flag_stuck(f"round:{rid}"),
             tracer.flag_stuck("nope")]
    dur = tracer.mark_closed(f"round:{rid}", name="round", cat="tick",
                             args={"placed": 1})
    tracer.set_enabled(False)
    tracer.emit("dropped", t0=tracer.now())
    tracer.mark_open("publish:1")
    tracer.set_enabled(True)
    for k in range(10):                      # past the ring's capacity
        tracer.emit(f"s{k}", t0=tracer.now(), track="pub")
    status = tracer.status()
    for v in status["open_marks"].values():
        v.pop("age_s")
    events = tracer.events()
    for e in events:
        e["track"] = e["track"] if e["track"] in ("coord", "pub") else "t"
    return dict(marks=marks, stuck=stuck, dur=dur, span_count=tracer.span_count,
                next_span=[tracer.next_span_id(), tracer.next_span_id()],
                events=events, tail=tracer.events(tail=3), status=status,
                chrome=len(tracer.chrome_trace()["traceEvents"]))


def test_span_tracer_matches_reference():
    got = _trace_sequence(importlib.import_module(
        "koordinator_tpu_torch.obs.trace"))
    want = _trace_sequence(importlib.import_module("koordinator_tpu.obs.trace"))
    assert got == want
    assert got["span_count"] == 14 and len(got["events"]) == 8


def _timeline_sequence(root):
    timeline = importlib.import_module(f"{root}.obs.timeline")
    registry = importlib.import_module(f"{root}.metrics.registry")
    hist = registry.Histogram("e2e", label_names=("lane",))
    drops = []
    tl = timeline.PodTimelines(capacity=3, completed_capacity=4,
                               clock=FakeClock(), histogram=hist)
    tl.set_drop_hook(drops.append)
    for uid, lane in (("a", "ls"), ("b", "be"), ("c", "system"),
                      ("d", "ls"), ("a", "be")):
        tl.submit(uid, lane)
    tl.mark_many(["a", "b", "zz"], "staged")
    tl.mark("c", "solved")
    with tl.preserved("b"):
        tl.forget("b")
        tl.submit("b", "be")
    e2e = [tl.published(u) for u in ("a", "b", "nope")]
    tl.note_shed("ls", "capacity", uid="c")
    tl.forget("c")
    status = tl.status()
    return dict(e2e=e2e, drops=drops, stats=tl.stats(),
                window=tl.stats(window_s=0.3), status=status,
                counts={lane: hist.count({"lane": lane})
                        for lane in ("ls", "be", "system")},
                sums={lane: hist.sum({"lane": lane})
                      for lane in ("ls", "be", "system")})


def test_pod_timelines_match_reference():
    got = _timeline_sequence("koordinator_tpu_torch")
    want = _timeline_sequence("koordinator_tpu")
    assert got == want
    assert got["drops"] == ["d"] and got["counts"]["be"] == 1


# -- the wired scheduler's spans and series --------------------------------------

def _scenario(P):
    """Rounds through a wired Scheduler: a low-priority pair placed, a
    preemptor that evicts one and binds a round later, a defrag drain,
    and a gang whose members wait at the Permit barrier past its
    WaitTime."""
    bus = P.bus()
    sched = P.scheduler()
    P.wiring.wire_scheduler(bus, sched)
    for name in ("n0", "n1"):
        bus.apply(P.Kind.NODE, name, P.node(name, cpu=10000, mem=32768))
        bus.apply(P.Kind.NODE_METRIC, name, P.metric(name))
    bus.apply(P.Kind.QUOTA, "a", P.T.QuotaSpec(
        name="a", min=P.res({CPU: 20000}), max=P.res({CPU: 20000})))
    for name in ("low0", "low1"):
        bus.apply(P.Kind.POD, f"default/{name}", P.pod(
            name, {CPU: 8000}, quota="a", priority=10))
    out = [dict(sched.schedule_pending(now=100.0))]
    bus.apply(P.Kind.POD, "default/high", P.pod(
        "high", {CPU: 4000}, quota="a", priority=100))
    result = sched.schedule_pending(now=101.0)
    out.append((dict(result), dict(result.nominations)))
    out.append(dict(sched.schedule_pending(now=102.0)))
    bus.apply(P.Kind.POD, "default/small", P.pod(
        "small", {CPU: 1000}, priority=5, qos=P.X.QoSClass.BE))
    out.append(dict(sched.schedule_pending(now=103.0)))
    target = np.zeros(len(P.X.ResourceName), np.int64)
    target[CPU] = 9000
    drain = sched.defrag_headroom(target, 50, apply=True, now=104.0)
    out.append(drain)
    bus.apply(P.Kind.GANG, "g", P.T.GangSpec(
        name="g", min_member=3, wait_time=30.0,
        mode=P.T.GangMode.NON_STRICT))
    for k in range(2):
        bus.apply(P.Kind.POD, f"default/g{k}", P.pod(
            f"g{k}", {CPU: 1000}, gang="g"))
    gang_round = sched.schedule_pending(now=105.0)
    out.append((dict(gang_round), dict(gang_round.waiting)))
    late = sched.schedule_pending(now=140.0)
    out.append((dict(late), dict(late.waiting)))
    return out


@pytest.mark.parametrize("backend", ["device", "host"])
def test_wired_scheduler_spans_and_series_match_reference(backend):
    records = []
    for P in (PORT, REF):
        trace = importlib.import_module(f"{P.root}.obs.trace")
        trace.TRACER.clear()
        before = series_values(P)
        make = P.scheduler
        P.scheduler = lambda **kw: make(preemption_backend=backend, **kw)
        try:
            out = _scenario(P)
        finally:
            del P.scheduler
        after = series_values(P)
        delta = {k: after[k] - before[k] for k in after
                 if not k.startswith("PENDING_PODS")}
        delta["PENDING_PODS"] = after["PENDING_PODS"]
        records.append((out, delta, spans_of(P)))
    assert records[0] == records[1]
    out, delta, (names, rounds, marks) = records[0]
    assert out[1][1] == {"default/high": out[0]["default/low0"]}
    assert delta["PREEMPTION_ATTEMPTS"] >= 1
    if backend == "device":
        assert delta["PREEMPT_VICTIMS[('outcome', 'evicted')]"] == 1
    assert delta["DEFRAG_DRAINS"] >= 1
    assert delta["GANG_REJECTIONS"] >= 1
    assert delta["POD_E2E[('lane', 'ls')]"] >= 2
    assert names["round"] == names["begin_tick"] == names["publish"] == 6
    assert rounds == list(range(6)) and marks == []
