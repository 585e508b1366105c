"""Seeded open-loop arrival traces for the streaming serving mode (a
copy of ``koordinator_tpu/testing/arrivals.py``: the same seeds give the
same arrivals, byte for byte, in both packages).

The continuous-arrival configuration (bench config #18) and the
streaming tests need *scenario diversity without
hand-written scenarios*: a pod stream whose shape — diurnal load
swings, heavy-tailed request sizes, burst storms, gang waves — is
drawn from a seeded generator, so every scenario is reproducible
forever from ``(kind, seed, rate, duration)`` alone. The TRACE is the
deterministic artifact (same seed → same arrivals, byte for byte);
what the scheduler does with it is the property under test.

An :class:`ArrivalTrace` is a time-sorted list of :class:`Arrival`
rows — relative timestamps (seconds from trace start), a pod name, a
QoS lane, resource requests, and an optional gang — that a driver
replays against a clock: the bench paces submissions on the wall
clock (open loop: arrivals never wait for the scheduler), the
property tests step a fake clock through the same timestamps.

Generators:

- :func:`diurnal_trace` — a non-homogeneous Poisson process whose
  rate swings sinusoidally between ``low_frac`` and 1.0 of the peak
  rate: the compressed day/night cycle a global user base produces.
- :func:`heavy_tail_trace` — Poisson arrivals with Pareto-distributed
  request sizes (many small pods, a heavy tail of large ones) and a
  small fraction of system-lane pods: the multi-workload mix.
- :func:`burst_storm_trace` — a baseline trickle plus scheduled
  storms: ``burst_pods`` arrivals packed into a few milliseconds
  (a deployment rollout / failover herd). The adaptive trigger's
  watermark must absorb these into few dispatches.
- :func:`gang_wave_trace` — waves of gang members arriving together
  on a cadence over a solo-pod baseline: the all-or-nothing batch
  workloads whose Permit barrier spans rounds.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Tuple

from koordinator_tpu_torch.apis.extension import QoSClass

#: lane mix (system, ls, be) used when a generator does not override it
_DEFAULT_LANE_MIX = (0.05, 0.65, 0.30)

_QOS_BY_LANE = {
    "system": QoSClass.SYSTEM,
    "ls": QoSClass.LS,
    "be": QoSClass.BE,
}


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One pod arrival: ``at`` is seconds from trace start."""

    at: float
    name: str
    lane: str  # system | ls | be
    cpu: int   # millicores
    memory: int  # MiB
    gang: Optional[str] = None

    @property
    def qos(self) -> QoSClass:
        return _QOS_BY_LANE[self.lane]


@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    """A time-sorted arrival sequence plus its provenance."""

    kind: str
    seed: int
    duration_s: float
    rate_pods_per_s: float
    arrivals: Tuple[Arrival, ...]

    def __len__(self) -> int:
        return len(self.arrivals)

    def __iter__(self):
        return iter(self.arrivals)


def _lane(rng: random.Random, mix=_DEFAULT_LANE_MIX) -> str:
    x = rng.random()
    if x < mix[0]:
        return "system"
    if x < mix[0] + mix[1]:
        return "ls"
    return "be"


def _small_pod(rng: random.Random) -> Tuple[int, int]:
    """The baseline request shape: 200-2000 mcpu, 128-2048 MiB."""
    return rng.randrange(200, 2000), rng.randrange(128, 2048)


def _finish(kind: str, seed: int, duration_s: float, rate: float,
            rows: List[Arrival]) -> ArrivalTrace:
    rows.sort(key=lambda a: (a.at, a.name))
    return ArrivalTrace(
        kind=kind, seed=seed, duration_s=duration_s,
        rate_pods_per_s=rate, arrivals=tuple(rows),
    )


def diurnal_trace(seed: int, duration_s: float = 10.0,
                  rate_pods_per_s: float = 200.0,
                  low_frac: float = 0.2,
                  cycles: float = 1.0) -> ArrivalTrace:
    """Sinusoidal-rate Poisson arrivals: the instantaneous rate swings
    between ``low_frac * rate`` and ``rate`` over ``cycles`` full
    day-cycles compressed into ``duration_s`` (thinning method, so the
    process is exactly non-homogeneous Poisson)."""
    rng = random.Random(f"diurnal:{seed}")
    rows: List[Arrival] = []
    t, i = 0.0, 0
    peak = max(1e-9, rate_pods_per_s)
    while True:
        t += rng.expovariate(peak)  # candidate at the peak rate
        if t >= duration_s:
            break
        phase = 2.0 * math.pi * cycles * t / duration_s
        frac = low_frac + (1.0 - low_frac) * 0.5 * (1 - math.cos(phase))
        if rng.random() > frac:
            continue  # thinned: off-peak hours
        cpu, mem = _small_pod(rng)
        rows.append(Arrival(
            at=t, name=f"d{seed}p{i}", lane=_lane(rng), cpu=cpu,
            memory=mem,
        ))
        i += 1
    return _finish("diurnal", seed, duration_s, rate_pods_per_s, rows)


def heavy_tail_trace(seed: int, duration_s: float = 10.0,
                     rate_pods_per_s: float = 200.0,
                     tail_alpha: float = 1.3,
                     cpu_cap: int = 16000) -> ArrivalTrace:
    """Poisson arrivals whose request sizes follow a (capped) Pareto:
    the p50 pod is small, the p99 pod is an order of magnitude larger
    — the mix that makes tail latency a packing problem, not only a
    queueing one."""
    rng = random.Random(f"heavy-tail:{seed}")
    rows: List[Arrival] = []
    t, i = 0.0, 0
    while True:
        t += rng.expovariate(max(1e-9, rate_pods_per_s))
        if t >= duration_s:
            break
        # capped Pareto over [200, cpu_cap] millicores; memory scales
        cpu = min(cpu_cap, int(200 * rng.paretovariate(tail_alpha)))
        mem = min(32768, max(128, cpu))
        rows.append(Arrival(
            at=t, name=f"h{seed}p{i}", lane=_lane(rng), cpu=cpu,
            memory=mem,
        ))
        i += 1
    return _finish("heavy-tail", seed, duration_s, rate_pods_per_s, rows)


def burst_storm_trace(seed: int, duration_s: float = 10.0,
                      rate_pods_per_s: float = 50.0,
                      bursts: int = 3, burst_pods: int = 64,
                      burst_span_s: float = 0.005) -> ArrivalTrace:
    """A baseline Poisson trickle plus ``bursts`` storms: each packs
    ``burst_pods`` arrivals into ``burst_span_s`` at seeded instants
    (never in the first or last tenth of the trace, so a mid-storm
    fault injection has runway on both sides)."""
    rng = random.Random(f"burst-storm:{seed}")
    rows: List[Arrival] = []
    t, i = 0.0, 0
    while True:
        t += rng.expovariate(max(1e-9, rate_pods_per_s))
        if t >= duration_s:
            break
        cpu, mem = _small_pod(rng)
        rows.append(Arrival(
            at=t, name=f"b{seed}p{i}", lane=_lane(rng), cpu=cpu,
            memory=mem,
        ))
        i += 1
    for b in range(bursts):
        at0 = rng.uniform(0.1 * duration_s, 0.9 * duration_s)
        for j in range(burst_pods):
            cpu, mem = _small_pod(rng)
            rows.append(Arrival(
                at=at0 + rng.uniform(0.0, burst_span_s),
                name=f"b{seed}s{b}p{j}",
                # storms skew latency-sensitive: the rollout herd
                lane="ls" if rng.random() < 0.8 else "be",
                cpu=cpu, memory=mem,
            ))
    return _finish("burst-storm", seed, duration_s, rate_pods_per_s,
                   rows)


def gang_wave_trace(seed: int, duration_s: float = 10.0,
                    rate_pods_per_s: float = 50.0,
                    waves: int = 4, gang_size: int = 4,
                    wave_span_s: float = 0.002) -> ArrivalTrace:
    """Solo-pod baseline plus ``waves`` gang waves: each wave is one
    gang's ``gang_size`` members arriving within ``wave_span_s`` —
    the co-scheduled batch jobs whose Permit barrier must bridge
    adaptively-fired rounds."""
    rng = random.Random(f"gang-wave:{seed}")
    rows: List[Arrival] = []
    t, i = 0.0, 0
    while True:
        t += rng.expovariate(max(1e-9, rate_pods_per_s))
        if t >= duration_s:
            break
        cpu, mem = _small_pod(rng)
        rows.append(Arrival(
            at=t, name=f"g{seed}p{i}", lane=_lane(rng), cpu=cpu,
            memory=mem,
        ))
        i += 1
    for w in range(waves):
        at0 = rng.uniform(0.05 * duration_s, 0.95 * duration_s)
        for j in range(gang_size):
            rows.append(Arrival(
                at=at0 + rng.uniform(0.0, wave_span_s),
                name=f"g{seed}w{w}m{j}", lane="ls",
                cpu=800, memory=256, gang=f"wave{seed}-{w}",
            ))
    return _finish("gang-wave", seed, duration_s, rate_pods_per_s, rows)


#: the convergence scenario's load regimes: time-dilation
#: factors applied to ONE seeded trace — same pods, same order, same
#: relative shape, 3 sustained-rate points
REGIMES: Dict[str, float] = {
    "low": 0.25,
    "mid": 1.0,
    "saturating": 4.0,
}


def regime_scale(trace: ArrivalTrace, regime) -> ArrivalTrace:
    """Replay ONE seeded trace at another load regime without
    re-deriving seeds: a time-dilation by ``factor`` (a
    :data:`REGIMES` name or a float) divides every arrival timestamp
    and the duration by the factor, multiplying the sustained rate —
    the pod SEQUENCE (names, lanes, sizes, gangs, relative shape) is
    byte-identical across regimes, so a controller property like
    "converges at low/mid/saturating" is tested against the same
    workload, not three different random draws."""
    factor = REGIMES[regime] if isinstance(regime, str) else float(regime)
    if factor <= 0:
        raise ValueError(f"regime factor must be positive: {factor}")
    label = regime if isinstance(regime, str) else f"x{factor:g}"
    if factor == 1.0:
        scaled = trace.arrivals
    else:
        scaled = tuple(
            dataclasses.replace(a, at=a.at / factor)
            for a in trace.arrivals
        )
    return ArrivalTrace(
        kind=f"{trace.kind}@{label}",
        seed=trace.seed,
        duration_s=trace.duration_s / factor,
        rate_pods_per_s=trace.rate_pods_per_s * factor,
        arrivals=scaled,
    )


#: generator registry: scenario diversity is data-driven — benches and
#: tests iterate this instead of hand-picking scenarios
TRACE_KINDS: Dict[str, object] = {
    "diurnal": diurnal_trace,
    "heavy-tail": heavy_tail_trace,
    "burst-storm": burst_storm_trace,
    "gang-wave": gang_wave_trace,
}


def make_trace(kind: str, seed: int, **kwargs) -> ArrivalTrace:
    """Build a trace by kind name (see :data:`TRACE_KINDS`)."""
    try:
        gen = TRACE_KINDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown arrival trace kind {kind!r}; "
            f"one of {sorted(TRACE_KINDS)}"
        ) from None
    return gen(seed, **kwargs)


def trace_pods(trace: ArrivalTrace, gang_min_member: Optional[int] = None):
    """Materialize a trace's arrivals as ``(at, PodSpec)`` pairs (and
    the gang specs it references, as ``{name: GangSpec}``) — the bus
    objects a driver applies. Import-light: apis.types only."""
    from koordinator_tpu_torch.apis.extension import ResourceName
    from koordinator_tpu_torch.apis.types import GangMode, GangSpec, PodSpec

    gangs: Dict[str, object] = {}
    pairs = []
    for a in trace:
        if a.gang and a.gang not in gangs:
            size = gang_min_member
            if size is None:
                size = sum(1 for x in trace if x.gang == a.gang)
            gangs[a.gang] = GangSpec(
                name=a.gang, min_member=size, mode=GangMode.NON_STRICT,
            )
        pairs.append((a.at, PodSpec(
            name=a.name,
            requests={ResourceName.CPU: a.cpu, ResourceName.MEMORY: a.memory},
            qos=a.qos, gang=a.gang,
        )))
    return pairs, gangs
