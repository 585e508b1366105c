"""Multi-tenant solver pool (counterpart of
``koordinator_tpu/service/tenancy.py``): K scheduler front-ends share one
solver sidecar, their per-tick solves batched across tenants as lanes of
one kernel launch.

Each tenant keeps its own staged world, its own wire-delta epoch chain,
QoS budgets and deadline accounting. The isolation contract is the
reference's:

- *No cross-tenant base merge*: the gate's coalesce fingerprint
  (``service/admission.coalesce_key``) is salted with the tenant, so two
  tenants shipping byte-identical worlds ride separate lanes with
  separate bases.
- *Bit-identical placements*: the solver is integer arithmetic end to
  end, so each lane's output equals that tenant solving solo.
- *Per-tenant epochs*: delta bases are kept per tenant per connection
  (``service/server.py``).
- *Per-tenant overload accounting* and the weighted fair share
  (:func:`fair_share`, :func:`allocate_fair_lanes`).

The reference stacks the lanes into pow2 node, pod and lane buckets so
that tenants drifting inside a bucket reuse one compiled XLA program,
and shards the lane axis over a device mesh. On one card with eager
PyTorch neither is needed: the lanes are padded only to the batch's
largest world and pod count (unschedulable zero nodes, blocked pods),
and the whole batch is one launch of the placement kernel with the lane
on the grid's y axis (``ops/binpack_kernel.binpack_lanes``). The bucket
helpers are kept for API parity (:func:`shape_bucket_key` hashes them,
so the batching keys are the reference's bytes).
"""

from __future__ import annotations

import hashlib
import re
import threading
from typing import Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from koordinator_tpu_torch import DeviceLike, resolve_device
from koordinator_tpu_torch.ops.binpack import (
    STAGED_NODE_FIELDS,
    NodeState,
    PodBatch,
    ScoreParams,
    SolverConfig,
    solve_batch,
)
from koordinator_tpu_torch.obs.device import DEVICE_OBS
from koordinator_tpu_torch.ops.binpack_kernel import (
    LaneInputs,
    kernel_route,
    lane_inputs,
    lane_route,
    lanes_assign_program,
    lanes_program,
)
from koordinator_tpu_torch.parallel.mesh import pow2_quarter_bucket
from koordinator_tpu_torch.service.codec import SolveRequest, SolveResponse
from koordinator_tpu_torch.service.warmpool import WARM_POOL
from koordinator_tpu_torch.state.workingset import WorkingSetExhausted

#: requests without a wire tenant belong to the default tenant
DEFAULT_TENANT = "default"

#: wire tenant ids are bounded (they become stats keys and label values)
MAX_TENANT_LEN = 64

#: anything outside the label-safe alphabet maps to ``_``
_TENANT_CHAR_RE = re.compile(r"[^A-Za-z0-9._\-]")

#: per-tenant accounting is keyed by the wire tenant id; ids past this
#: distinct-count cap fold into :data:`OVERFLOW_TENANT` (registered
#: tenants are always tracked)
MAX_TRACKED_TENANTS = 256
OVERFLOW_TENANT = "_overflow"


def request_tenant(req: SolveRequest) -> str:
    """The request's tenant from the wire ``admission`` group
    (``tenant``: utf-8 bytes as a uint8 array); absent or undecodable
    means :data:`DEFAULT_TENANT`. Truncated to :data:`MAX_TENANT_LEN` and
    sanitized to ``[A-Za-z0-9._-]``."""
    adm = req.admission
    if not adm or "tenant" not in adm:
        return DEFAULT_TENANT
    try:
        raw = bytes(np.asarray(adm["tenant"], np.uint8))
        name = raw.decode("utf-8")
    except (TypeError, ValueError, UnicodeDecodeError):
        return DEFAULT_TENANT
    name = _TENANT_CHAR_RE.sub("_", name[:MAX_TENANT_LEN])
    return name if name else DEFAULT_TENANT


def tenant_wire_value(tenant: str) -> np.ndarray:
    """Encode a tenant id for the ``admission`` group (client half)."""
    return np.frombuffer(tenant.encode("utf-8"), dtype=np.uint8)


# -- shape buckets (API parity: the keys hash them) ---------------------------

def node_bucket(n: int) -> int:
    """The reference's staged node-axis bucket for a world of ``n``
    nodes (the port pads only to the batch's largest world)."""
    return pow2_quarter_bucket(n, floor=8)


def pod_bucket(p: int) -> int:
    """The reference's stacked pod-axis bucket for ``p`` pending pods."""
    return pow2_quarter_bucket(p, floor=8)


def lane_bucket(k: int, shards: int = 1) -> int:
    """The reference's lane-count bucket: a power of two of per-shard
    lanes times the shard count (the port launches exactly k lanes)."""
    shards = max(1, shards)
    per_shard = -(-max(1, k) // shards)
    return shards * (1 << (per_shard - 1).bit_length())


#: params every solve must carry (ScoreParams schema)
_PARAM_FIELDS = ScoreParams._fields
#: pod columns PodBatch.build accepts; the first four are required
_POD_FIELDS = PodBatch._fields
_POD_REQUIRED = ("req", "est", "is_prod", "is_daemonset")


def _complete_schema(req: SolveRequest) -> bool:
    return (set(_POD_REQUIRED) <= set(req.pods)
            and set(req.pods) <= set(_POD_FIELDS)
            and set(_PARAM_FIELDS) <= set(req.params))


def plain_request(req: SolveRequest) -> bool:
    """Whether ``req`` is a plain full-state solve: no feature groups, no
    delta protocol, the full staged node schema, a complete pod and
    params schema. Only plain (and pure delta) requests batch."""
    if (req.quota is not None or req.gang is not None
            or req.extras is not None or req.resv is not None
            or req.numa is not None or req.node_delta is not None):
        return False
    if set(req.node) != set(STAGED_NODE_FIELDS):
        return False  # NUMA inventories (or a short node group) ride solo
    return _complete_schema(req)


def _schema_digest(req: SolveRequest, node_cols: Mapping[str, np.ndarray],
                   n_nodes: int) -> bytes:
    """The shape fingerprint: node, pod and param schema with bucketed
    leading axes, and the static config values (the reference's bytes)."""
    h = hashlib.blake2b(digest_size=16)

    def feed_schema(tag: str, a: np.ndarray, lead_bucket=None) -> None:
        h.update(tag.encode())
        h.update(str(a.dtype).encode())
        if lead_bucket is None:
            h.update(repr(a.shape).encode())
        else:
            h.update(repr((lead_bucket,) + a.shape[1:]).encode())

    p = int(np.asarray(req.pods["req"]).shape[0])
    nb, pb = node_bucket(n_nodes), pod_bucket(p)
    for f in STAGED_NODE_FIELDS:
        feed_schema("n." + f, np.asarray(node_cols[f]), lead_bucket=nb)
    for f in sorted(req.pods):
        feed_schema("p." + f, np.asarray(req.pods[f]), lead_bucket=pb)
    for f in sorted(req.params):
        feed_schema("s." + f, np.asarray(req.params[f]))
    if req.config is not None:
        for f in sorted(req.config):
            a = np.asarray(req.config[f])
            feed_schema("c." + f, a)
            h.update(np.ascontiguousarray(a).tobytes())
    return h.digest()


def shape_bucket_key(req: SolveRequest) -> Optional[bytes]:
    """The shape-level fingerprint for cross-tenant lane batching, or
    None when the request cannot batch: requests with equal keys may be
    lanes of one launch though their data differ."""
    if not plain_request(req):
        return None
    n = int(np.asarray(req.node["alloc"]).shape[0])
    return _schema_digest(req, req.node, n)


def delta_request(req: SolveRequest) -> bool:
    """Whether ``req`` is a pure delta solve: a ``node_delta`` row patch
    against the tenant's cached base, no feature groups, no inline node
    group, a well-formed patch and a complete pod and params schema (a
    malformed patch rides solo, so its failure is its own)."""
    if (req.quota is not None or req.gang is not None
            or req.extras is not None or req.resv is not None
            or req.numa is not None):
        return False
    if req.node:
        return False
    delta = req.node_delta
    if not delta or "idx" not in delta or "base_epoch" not in delta:
        return False
    if "epoch" not in delta:
        return False
    idx = np.asarray(delta["idx"])
    if idx.ndim != 1:
        return False
    for f in STAGED_NODE_FIELDS:
        if f not in delta:
            return False
        if np.asarray(delta[f]).shape[:1] != idx.shape[:1]:
            return False
    return _complete_schema(req)


def delta_shape_key(req: SolveRequest, node_cache) -> Optional[bytes]:
    """The shape key of a delta request against its tenant's established
    base, or None when it must ride solo (not a pure delta, no base, or
    a base/epoch mismatch: the solo path answers the typed
    ``delta-base-mismatch``). Safe at submit time: caches change only on
    the gate's executor, and a connection has one request in flight."""
    if not delta_request(req):
        return None
    if node_cache is None or node_cache.host is None or node_cache.epoch is None:
        return None
    try:
        base = int(np.asarray(req.node_delta["base_epoch"]).item())
    except (TypeError, ValueError):
        return None
    if node_cache.epoch != base:
        return None
    n = int(node_cache.host["alloc"].shape[0])
    return _schema_digest(req, node_cache.host, n)


# -- weighted-fair arbitration ----------------------------------------------

def fair_share(capacity: int, weights: Mapping[str, float]) -> Dict[str, int]:
    """Per-tenant queue fair share: ``capacity`` split in proportion to
    the weights (floor 1)."""
    total = sum(max(0.0, w) for w in weights.values()) or 1.0
    return {
        t: max(1, int(capacity * max(0.0, w) / total))
        for t, w in weights.items()
    }


def allocate_fair_lanes(
    candidates: Mapping[str, Sequence],
    weight_of: Callable[[str], float],
    budget: int,
    room: int,
    pods_of: Callable[[object], int],
    preloaded: Optional[Mapping[str, int]] = None,
) -> List[object]:
    """Split one dispatch's lane budget across tenants by weight: weighted
    round-robin, the next entry of the tenant with the smallest granted /
    weight ratio (ties on tenant name), entries larger than the remaining
    pod ``room`` skipped in FIFO order."""
    cursors = {t: 0 for t in candidates}
    granted: Dict[str, int] = dict(preloaded or {})
    out: List[object] = []
    while budget > 0:
        best: Optional[str] = None
        best_ratio = None
        for t in sorted(candidates):
            q = candidates[t]
            i = cursors[t]
            while i < len(q) and pods_of(q[i]) > room:
                i += 1
            cursors[t] = i
            if i >= len(q):
                continue
            w = max(1e-9, weight_of(t))
            ratio = granted.get(t, 0) / w
            if best is None or ratio < best_ratio:
                best, best_ratio = t, ratio
        if best is None:
            break
        entry = candidates[best][cursors[best]]
        cursors[best] += 1
        granted[best] = granted.get(best, 0) + 1
        room -= pods_of(entry)
        budget -= 1
        out.append(entry)
    return out


class TenantRegistry:
    """Weights of the pool's tenants (unregistered tenants weigh 1)."""

    DEFAULT_WEIGHT = 1.0

    def __init__(self, weights: Optional[Mapping[str, float]] = None):
        self._lock = threading.Lock()
        self._weights: Dict[str, float] = dict(weights or {})

    def set_weight(self, tenant: str, weight: float) -> None:
        if weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {weight}")
        with self._lock:
            self._weights[tenant] = float(weight)

    def weight(self, tenant: str) -> float:
        with self._lock:
            return self._weights.get(tenant, self.DEFAULT_WEIGHT)

    def weights_for(self, tenants) -> Dict[str, float]:
        with self._lock:
            return {t: self._weights.get(t, self.DEFAULT_WEIGHT)
                    for t in tenants}

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._weights)


# -- the lane solve ---------------------------------------------------------

def decode_config(group) -> SolverConfig:
    """The wire ``config`` group as this package's ``SolverConfig``: only
    its own fields are read, so the reference's ``unroll`` and
    ``kernel_unroll`` (scan unroll factors, which change no result) are
    ignored."""
    if group is None:
        return SolverConfig()
    defaults = SolverConfig()
    kwargs = {}
    for f in SolverConfig._fields:
        if f in group:
            kwargs[f] = type(getattr(defaults, f))(np.asarray(group[f]).item())
    return SolverConfig(**kwargs)


def wire_kernel_supported(params: Mapping[str, np.ndarray],
                          config: SolverConfig) -> bool:
    """``kernel_supported`` from a request's wire params (no device
    read): unit plugin weights, no prod-usage thresholds or scoring."""
    return (not config.score_according_prod
            and config.fit_weight == 1 and config.loadaware_weight == 1
            and not np.asarray(params["prod_thresholds"]).any())


def lanes_kernel_ok(params: Sequence[Mapping[str, np.ndarray]],
                    config: SolverConfig, n_nodes: int) -> bool:
    """Whether a lane batch goes to the kernel: every lane's params and
    the config are ones the kernel takes (:func:`wire_kernel_supported`)
    and a kernel takes the lanes' node count; otherwise every lane takes
    the loop ``solve_batch``."""
    return (all(wire_kernel_supported(p, config) for p in params)
            and kernel_route(n_nodes) is not None)


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with zero rows appended to ``n`` rows (zero is False: an
    unschedulable, empty node; a pod row then blocked by its flag)."""
    if t.shape[0] == n:
        return t
    return torch.cat([t, t.new_zeros((n - t.shape[0],) + tuple(t.shape[1:]))])


def _lane_pods(pods: Sequence[Mapping[str, np.ndarray]], p: int,
               device: torch.device) -> PodBatch:
    """The lanes' pod columns ``[K, p, ...]``, each lane padded with
    blocked pods to ``p``."""
    counts = [int(np.asarray(g["req"]).shape[0]) for g in pods]
    blocked = np.ones((len(pods), p), bool)
    for i, (g, c) in enumerate(zip(pods, counts)):
        blocked[i, :c] = np.asarray(g["blocked"]) if "blocked" in g else False
    cols = {}
    for f in sorted(set(pods[0]) - {"blocked"}):
        lanes = []
        for g, c in zip(pods, counts):
            a = np.asarray(g[f])
            lanes.append(np.concatenate(
                [a, np.zeros((p - c,) + a.shape[1:], a.dtype)]))
        cols[f] = torch.as_tensor(np.stack(lanes), device=device)
    k = len(pods)
    defaults = {
        "quota_id": torch.full((k, p), -1, dtype=torch.int32, device=device),
        "non_preemptible": torch.zeros((k, p), dtype=torch.bool,
                                       device=device),
        "gang_id": torch.full((k, p), -1, dtype=torch.int32, device=device),
    }
    return PodBatch(
        **{f: cols.get(f, defaults.get(f)) for f in PodBatch._fields
           if f not in ("blocked", "has_numa_policy")},
        blocked=torch.as_tensor(blocked, device=device),
        has_numa_policy=cols.get("has_numa_policy"))


def stage_lanes(bases: Sequence[NodeState],
                pods: Sequence[Mapping[str, np.ndarray]],
                params: Sequence[Mapping[str, np.ndarray]],
                device: torch.device) -> LaneInputs:
    """K lanes stacked for ``binpack_lanes``: one base for every lane
    (``len(bases) == 1``) or a base per lane padded to the largest world
    with unschedulable zero rows; each lane's pods (wire columns) padded
    to the largest count with blocked pods; each lane's params."""
    n = max(int(s.alloc.shape[0]) for s in bases)
    p = max(int(np.asarray(g["req"]).shape[0]) for g in pods)
    state = NodeState(*(
        None if getattr(bases[0], f) is None
        else torch.stack([_pad_rows(getattr(s, f), n) for s in bases])
        for f in NodeState._fields))
    score = ScoreParams(**{
        f: torch.as_tensor(np.stack([np.asarray(g[f]) for g in params]),
                           device=device)
        for f in ScoreParams._fields})
    return lane_inputs(state, _lane_pods(pods, p, device), score)


#: the tenant pool's lane solves (a base per lane), adopted into the warm
#: pool: a new tenant whose batch lands in a restored shape replays
_jit_tenant = DEVICE_OBS.bind("tenant_lane_solve", lanes_assign_program)
_jit_tenant_full = DEVICE_OBS.bind("tenant_lane_solve_full", lanes_program)
WARM_POOL.adopt(_jit_tenant, config_argpos=1)
WARM_POOL.adopt(_jit_tenant_full, config_argpos=1)


def solve_lanes(bases: Sequence[NodeState],
                pods: Sequence[Mapping[str, np.ndarray]],
                params: Sequence[Mapping[str, np.ndarray]],
                config: SolverConfig, want_state: bool,
                device: torch.device,
                bindings=None) -> List[SolveResponse]:
    """K independent plain solves, lane ``i`` of ``pods[i]`` against
    ``bases[i]`` (or ``bases[0]`` for every lane when there is one base)
    with ``params[i]``, as one lane-batched launch of the placement
    kernel (``binpack_lanes`` over :func:`stage_lanes`), or, when the
    batch is not one the kernel takes (:func:`lanes_kernel_ok`), the loop
    ``solve_batch`` lane by lane. Every response equals the lane solved
    alone. The launch goes through ``bindings`` (assign-only, full),
    the tenant pool's unless given (the gate passes its own)."""
    k = len(pods)
    counts = [int(np.asarray(g["req"]).shape[0]) for g in pods]
    node_counts = [int(s.alloc.shape[0]) for s in bases]
    if len(bases) == 1:
        node_counts *= k
    if lanes_kernel_ok(params, config, max(node_counts)):
        assign_only, full = bindings or (_jit_tenant, _jit_tenant_full)
        inp = stage_lanes(bases, pods, params, device)
        if want_state:
            out = full(inp, lane_route(inp))
            assign_all = out.assign.cpu().numpy()
            used_all = out.used.cpu().numpy()
        else:
            assign_all = assign_only(inp, lane_route(inp)).cpu().numpy()
            used_all = None
    else:
        assign_all = np.full((k, max(counts)), -1, np.int32)
        used_all = []
        for i in range(k):
            base = bases[i if len(bases) > 1 else 0]
            one = _lane_pods([pods[i]], counts[i], device)
            result = solve_batch(
                base, PodBatch(*(None if t is None else t[0] for t in one)),
                ScoreParams(**{f: torch.as_tensor(np.asarray(params[i][f]),
                                                  device=device)
                               for f in ScoreParams._fields}), config)
            assign_all[i, :counts[i]] = result.assign.cpu().numpy()
            used_all.append(result.node_state.used_req.cpu().numpy())
    out_list: List[SolveResponse] = []
    for i, (c, nn) in enumerate(zip(counts, node_counts)):
        a = np.asarray(assign_all[i, :c], np.int32)
        out_list.append(SolveResponse(
            assignments=a,
            node_used_req=None if not want_state else used_all[i][:nn],
            # plain solves commit exactly their placed pods
            commit=a >= 0,
            waiting=np.zeros(c, bool),
            rejected=np.zeros(c, bool),
            raw_assign=a,
        ))
    return out_list


def wire_state(node: Mapping[str, np.ndarray], device) -> NodeState:
    """A wire ``node`` group's staged columns as a ``NodeState``."""
    return NodeState(**{f: torch.as_tensor(np.asarray(node[f]), device=device)
                        for f in STAGED_NODE_FIELDS})


def _solve_lanes(pairs, config, want_state: bool,
                 device: torch.device) -> List[SolveResponse]:
    """``pairs`` is ``[(request, staged state or None), ...]``: a lane's
    world is its wire ``node`` group (plain request) or its tenant's
    staged state (delta request, already patched). One lane batch; the
    head's wire config rules."""
    head = pairs[0][0]
    if head.config is not None:
        config = decode_config(head.config)
    elif config is None:
        config = SolverConfig()
    bases = [state if state is not None else wire_state(r.node, device)
             for r, state in pairs]
    return solve_lanes(bases, [r.pods for r, _ in pairs],
                       [r.params for r, _ in pairs], config, want_state,
                       device)


def solve_tenant_lanes(
    requests: Sequence[SolveRequest],
    config: Optional[SolverConfig] = SolverConfig(),
    want_state: bool = False,
    device: DeviceLike = None,
) -> List[SolveResponse]:
    """Solve K tenants' plain requests (separate worlds and params) as
    lanes of one launch and split the results back per tenant; each
    response equals ``solve_from_request`` of that request alone
    (``want_state=True`` adds each lane's ``node_used_req``)."""
    return _solve_lanes([(r, None) for r in requests], config, want_state,
                        resolve_device(device))


def solve_entry_lanes(entries, config=None,
                      device: DeviceLike = None) -> List[SolveResponse]:
    """The gate's lane dispatch over admission entries: a plain request's
    world comes from the wire, a delta request's from its tenant's base,
    patched here on the executor thread (``NodeStateCache.apply``)."""
    device = resolve_device(device)
    pairs = []
    slots: List[Optional[int]] = []
    failed: Dict[int, SolveResponse] = {}
    for i, e in enumerate(entries):
        req = e.request
        state = None
        if delta_request(req):
            # an earlier entry's restage in this loop may have demoted
            # this base under memory pressure: a cold base or an
            # exhausted budget costs this entry a typed error, never the
            # lanes batched with it
            cache = e.node_cache
            if cache is None or cache.host is None:
                failed[i] = SolveResponse(
                    assignments=np.empty(0, np.int32),
                    error="delta-base-mismatch: no base held (or demoted "
                          "cold under memory pressure), re-establish")
                slots.append(None)
                continue
            try:
                state = cache.apply(req.node_delta)
            except WorkingSetExhausted as exc:
                failed[i] = SolveResponse(
                    assignments=np.empty(0, np.int32),
                    error=f"overloaded: {exc}")
                slots.append(None)
                continue
        slots.append(len(pairs))
        pairs.append((req, state))
    solved = _solve_lanes(pairs, config, False, device) if pairs else []
    return [failed[i] if slot is None else solved[slot]
            for i, slot in enumerate(slots)]
