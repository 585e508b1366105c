"""The extension-point protocol and the per-pod scheduling cycle
(counterpart of ``koordinator_tpu/scheduler/framework.py``).

Mirrors the reference's framework-extender architecture
(pkg/scheduler/frameworkext/framework_extender.go:167-262, and the
transformer extension points of interface.go:78-97): plugins see typed
snapshots and may rewrite the pod or node view before each phase. The
per-pod cycle is the semantics oracle of the batched solver and the path
for one-off placements (``Scheduler.schedule_one``, and whole rounds with
the ``BatchedPlacement`` gate off): tiny clusters, tests, debug dumps.
The batched round drives the NodeNUMAResource, DeviceShare and NodePorts
plugins through ``models/finegrained.FineGrained`` with the same
extension points.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

MAX_NODE_SCORE = 100


class CycleState(dict):
    """Per-scheduling-cycle scratch space shared between plugins
    (reference: framework.CycleState)."""


class Status:
    """Plugin status: success (None reason) or failure with a reason."""

    def __init__(self, reason: Optional[str] = None,
                 unschedulable: bool = False):
        self.reason = reason
        self.unschedulable = unschedulable

    @property
    def ok(self) -> bool:
        return self.reason is None

    @classmethod
    def success(cls) -> "Status":
        return cls()

    @classmethod
    def unschedulable_(cls, reason: str) -> "Status":
        return cls(reason=reason, unschedulable=True)

    def __repr__(self) -> str:
        return f"Status(ok={self.ok}, reason={self.reason!r})"


class Plugin:
    """Base plugin: every extension point a no-op success. In cycle order,
    the k8s framework's points plus the koordinator transformers:

    - before_pre_filter(state, snapshot, pod) -> bool: may change the
      cycle's view (the reservation restore); True if anything changed
    - pre_filter(state, snapshot, pod) -> Status: admission gates
    - after_pre_filter(state, snapshot, pod): runs once after PreFilter
    - before_filter(state, snapshot, pod, node) -> None | (pod, node)
    - filter(state, snapshot, pod, node) -> Status: per-node feasibility
    - before_score(state, snapshot, pod, nodes) -> None | (pod, nodes)
    - score(state, snapshot, pod, node) -> int (0..100), weighted by
      score_weight()
    - reserve(state, snapshot, pod, node) -> Status / unreserve(...)
    - permit(state, snapshot, pod, node) -> ("allow"|"wait"|"reject", t)
    - pre_bind(state, snapshot, pod, node) -> Status: final mutations
    - post_filter(state, snapshot, pod): when no node is feasible (or
      PreFilter refused): the failure fan-out, or a preemption
      nomination ``(node name, [victim PodSpec])``
    """

    name = "Plugin"

    def before_pre_filter(self, state: CycleState, snapshot, pod) -> bool:
        return False

    def after_pre_filter(self, state: CycleState, snapshot, pod) -> None:
        """Correct per-plugin cycle state after every PreFilter ran
        (reference: PreFilterTransformer.AfterPreFilter,
        interface.go:83-85)."""

    def pre_filter(self, state: CycleState, snapshot, pod) -> Status:
        return Status.success()

    def before_filter(self, state: CycleState, snapshot, pod, node):
        """May substitute the (pod, node) the Filter phase sees for this
        node (reference: FilterTransformer.BeforeFilter,
        interface.go:88-92). None leaves them unchanged."""
        return None

    def filter(self, state: CycleState, snapshot, pod, node) -> Status:
        return Status.success()

    def before_score(self, state: CycleState, snapshot, pod, nodes):
        """May substitute the (pod, feasible nodes) the Score phase sees
        (reference: ScoreTransformer.BeforeScore, interface.go:95-97).
        None leaves them unchanged."""
        return None

    def score(self, state: CycleState, snapshot, pod, node) -> int:
        return 0

    def score_weight(self) -> int:
        return 1

    def reserve(self, state: CycleState, snapshot, pod, node) -> Status:
        return Status.success()

    def unreserve(self, state: CycleState, snapshot, pod, node) -> None:
        pass

    def permit(self, state: CycleState, snapshot, pod, node
               ) -> Tuple[str, float]:
        return ("allow", 0.0)

    def pre_bind(self, state: CycleState, snapshot, pod, node) -> Status:
        return Status.success()

    def post_filter(self, state: CycleState, snapshot, pod):
        """Called when every node was filtered out (the failure fan-out);
        a preemption plugin returns its nomination."""
        return None


@dataclasses.dataclass
class ScheduleOutcome:
    pod_uid: str
    node: Optional[str]
    #: bound | waiting | nominated | unschedulable | error
    status: str
    reason: str = ""
    #: the per-node totals, when the framework has a debug recorder
    scores: Optional[Dict[str, int]] = None
    #: a waiting outcome's cycle state, so the caller can roll back its
    #: Reserve-time holds if the Permit wait expires
    cycle_state: Optional[CycleState] = None
    #: a nominated outcome's victims: the uids to evict before the
    #: nominated node has room (PostFilter preemption)
    victims: Optional[List[str]] = None


class SchedulingFramework:
    """Runs one pod through the whole plugin chain."""

    def __init__(self, plugins: Sequence[Plugin], debug=None,
                 cycle_seed=None):
        self.plugins = list(plugins)
        self.debug = debug
        #: entries copied into every fresh CycleState: the per-scheduler
        #: configuration the shared lowering needs (the model's lowering
        #: kwargs and LoadAware thresholds)
        self.cycle_seed = dict(cycle_seed or {})

    def schedule_one(self, snapshot, pod) -> ScheduleOutcome:
        return self._schedule_one(snapshot, pod)

    def _run_post_filter(self, state, snapshot, pod
                         ) -> Optional[ScheduleOutcome]:
        """PostFilter: every plugin's side effects run (the gang
        rejection fan-out); the first preemption nomination wins
        (reference: framework RunPostFilterPlugins)."""
        nomination = None
        for plugin in self.plugins:
            result = plugin.post_filter(state, snapshot, pod)
            if result is not None and nomination is None:
                nomination = result
        if nomination is None:
            return None
        node_name, victims = nomination
        return ScheduleOutcome(
            pod.uid, node_name, "nominated",
            reason=f"preemption: {len(victims)} victim(s)",
            victims=[v.uid for v in victims])

    def _schedule_one(self, snapshot, pod) -> ScheduleOutcome:
        state = CycleState(self.cycle_seed)
        for plugin in self.plugins:
            plugin.before_pre_filter(state, snapshot, pod)
        after_pre_filter_ran = False

        def run_after_pre_filter():
            # once, whatever ends the PreFilter phase
            # (framework_extender.go:167-199 runs it on both outcomes)
            nonlocal after_pre_filter_ran
            if not after_pre_filter_ran:
                after_pre_filter_ran = True
                for plugin in self.plugins:
                    plugin.after_pre_filter(state, snapshot, pod)

        for plugin in self.plugins:
            status = plugin.pre_filter(state, snapshot, pod)
            if not status.ok:
                run_after_pre_filter()
                # an unschedulable PreFilter verdict (quota admission)
                # still reaches PostFilter, as the k8s framework's
                # scheduleOne error path does: ElasticQuota preemption
                # triggers on quota rejection
                nominated = self._run_post_filter(state, snapshot, pod)
                if nominated is not None:
                    return nominated
                return ScheduleOutcome(
                    pod.uid, None, "unschedulable",
                    f"{plugin.name}: {status.reason}")
        run_after_pre_filter()

        feasible = []
        for node in snapshot.nodes:
            if node.unschedulable:
                continue
            filter_pod, filter_node = pod, node
            for plugin in self.plugins:
                replaced = plugin.before_filter(state, snapshot, filter_pod,
                                                filter_node)
                if replaced is not None:
                    filter_pod, filter_node = replaced
            ok = True
            for plugin in self.plugins:
                status = plugin.filter(state, snapshot, filter_pod,
                                       filter_node)
                if not status.ok:
                    if self.debug is not None:
                        self.debug.record_filter(pod.uid, node.name,
                                                 plugin.name, status)
                    ok = False
                    break
            if ok:
                feasible.append(node)
        if not feasible:
            nominated = self._run_post_filter(state, snapshot, pod)
            if nominated is not None:
                return nominated
            return ScheduleOutcome(pod.uid, None, "unschedulable",
                                   "no feasible node")

        score_pod = pod
        for plugin in self.plugins:
            replaced = plugin.before_score(state, snapshot, score_pod,
                                           feasible)
            if replaced is not None:
                score_pod, feasible = replaced
        if not feasible:
            # a transformer filtered every candidate away
            nominated = self._run_post_filter(state, snapshot, pod)
            if nominated is not None:
                return nominated
            return ScheduleOutcome(pod.uid, None, "unschedulable",
                                   "no feasible node after transformers")

        # first max in node order
        best_node, best_score = None, -1
        all_scores: Dict[str, int] = {}
        for node in feasible:
            total = 0
            for plugin in self.plugins:
                total += plugin.score_weight() * plugin.score(
                    state, snapshot, score_pod, node)
            all_scores[node.name] = total
            if total > best_score:
                best_node, best_score = node, total
        if self.debug is not None:
            self.debug.record_scores(pod.uid, all_scores)

        for i, plugin in enumerate(self.plugins):
            status = plugin.reserve(state, snapshot, pod, best_node)
            if not status.ok:
                # unreserve every plugin up to and including the failing
                # one: a failing Reserve may have mutated state partly
                for done in self.plugins[: i + 1]:
                    done.unreserve(state, snapshot, pod, best_node)
                return ScheduleOutcome(
                    pod.uid, None, "unschedulable",
                    f"{plugin.name}: {status.reason}")

        for plugin in self.plugins:
            verdict, _wait = plugin.permit(state, snapshot, pod, best_node)
            if verdict == "wait":
                return ScheduleOutcome(pod.uid, best_node.name, "waiting",
                                       cycle_state=state)
            if verdict == "reject":
                for done in self.plugins:
                    done.unreserve(state, snapshot, pod, best_node)
                return ScheduleOutcome(
                    pod.uid, None, "unschedulable",
                    f"{plugin.name}: permit rejected")

        for plugin in self.plugins:
            status = plugin.pre_bind(state, snapshot, pod, best_node)
            if not status.ok:
                for done in self.plugins:
                    done.unreserve(state, snapshot, pod, best_node)
                return ScheduleOutcome(
                    pod.uid, None, "error", f"{plugin.name}: {status.reason}")

        return ScheduleOutcome(
            pod.uid, best_node.name, "bound",
            scores=all_scores if self.debug is not None else None)
