"""Pod mutating admission: ClusterColocationProfile injection + extended
resource translation.

The port's copy of ``koordinator_tpu/webhook/mutating.py``, equal to it bit for
bit (held by ``tests/test_torch_*.py`` on the same inputs).

Reference: pkg/webhook/pod/mutating/cluster_colocation_profile.go —
profiles select pods by namespace + object label selectors (:71-78) and
inject labels/annotations/key-mappings/QoS/priority (:157-235); then
``mutatePodResourceSpec`` (:238-263) translates native cpu/memory
requests+limits into the priority class's extended resources (batch-*/
mid-*) via the ResourceNameMap, skipping None/Prod pods.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from koordinator_tpu_torch.apis.extension import (
    PRIORITY_BANDS,
    PriorityClass,
    QoSClass,
    ResourceName,
    priority_class_of,
)
from koordinator_tpu_torch.apis.types import PodSpec, selector_matches
from koordinator_tpu_torch.state.cluster import translate_resource_by_priority


@dataclasses.dataclass
class ClusterColocationProfile:
    """A ClusterColocationProfile CR (apis/config/v1alpha1).

    Selectors are label subsets (the typed analogue of the reference's
    LabelSelectors); ``None`` means "match everything" like an absent
    selector.
    """

    name: str
    namespace_selector: Optional[Dict[str, str]] = None
    selector: Optional[Dict[str, str]] = None
    #: injected verbatim (profile.Spec.Labels / Annotations)
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: keyNew -> keyOld copies (profile.Spec.LabelKeysMapping etc.)
    label_keys_mapping: Dict[str, str] = dataclasses.field(default_factory=dict)
    annotation_keys_mapping: Dict[str, str] = dataclasses.field(default_factory=dict)
    qos_class: Optional[QoSClass] = None
    #: numeric k8s priority (profile.Spec.PriorityClassName resolved)
    priority: Optional[int] = None
    #: koordinator sub-priority within the band (KoordinatorPriority)
    koordinator_priority: Optional[int] = None

    def matches(self, pod: PodSpec, namespace_labels: Dict[str, str]) -> bool:
        if self.namespace_selector is not None and not selector_matches(
            self.namespace_selector, namespace_labels
        ):
            return False
        if self.selector is not None and not selector_matches(
            self.selector, pod.labels
        ):
            return False
        return True


#: node-selector value that matches no node label — the dict analogue of
#: the reference's unsatisfiable merged NodeSelectorRequirements (two In
#: requirements on one key with disjoint values)
UNSATISFIABLE = "\x00conflict"


class PodMutatingWebhook:
    """Applies every matching profile, the batch/mid resource rewrite,
    then multi-quota-tree affinity injection — the ingress every pod
    passes before reaching the scheduler."""

    def __init__(self, profiles: Optional[List[ClusterColocationProfile]] = None):
        self.profiles: Dict[str, ClusterColocationProfile] = {
            p.name: p for p in (profiles or [])
        }
        #: namespace -> labels (the reference reads Namespace objects)
        self.namespace_labels: Dict[str, Dict[str, str]] = {}
        #: optional right-sizer: pod -> recommended requests (the
        #: analysis.koordinator.sh consumption point; set by
        #: manager.recommendation.wire_recommendation)
        self.recommendation_for = None
        #: quota name -> QuotaSpec and quota-profile registries for the
        #: multi-quota-tree affinity mutator
        #: (multi_quota_tree_affinity.go:37-113)
        self.quota_specs: Dict[str, object] = {}
        self.quota_profiles: Dict[str, object] = {}

    def update_profile(self, profile: ClusterColocationProfile) -> None:
        self.profiles[profile.name] = profile

    # -- quota-tree registries (bus-fed) ------------------------------------

    def update_quota(self, spec) -> None:
        self.quota_specs[spec.name] = spec

    def remove_quota(self, name: str) -> None:
        self.quota_specs.pop(name, None)

    def update_quota_profile(self, profile) -> None:
        self.quota_profiles[profile.name] = profile

    def remove_quota_profile(self, name: str) -> None:
        self.quota_profiles.pop(name, None)

    def remove_profile(self, name: str) -> None:
        self.profiles.pop(name, None)

    def set_namespace_labels(self, namespace: str, labels: Dict[str, str]) -> None:
        self.namespace_labels[namespace] = dict(labels)

    # -- admission ----------------------------------------------------------

    def mutate(self, pod: PodSpec) -> PodSpec:
        """Mutate ``pod`` in place (and return it): profile injection in
        profile-name order, then extended-resource translation — which,
        like the reference (:66-69), only runs when at least one profile
        matched; unmanaged pods pass through untouched."""
        ns_labels = self.namespace_labels.get(pod.namespace, {})
        self._apply_recommendation(pod)
        matched = False
        for name in sorted(self.profiles):
            profile = self.profiles[name]
            if profile.matches(pod, ns_labels):
                self._apply_profile(pod, profile)
                matched = True
        if matched:
            self._mutate_resource_spec(pod)
        self._apply_tree_affinity(pod)
        return pod

    def _apply_tree_affinity(self, pod: PodSpec) -> None:
        """Multi-quota-tree node affinity (reference:
        pkg/webhook/pod/mutating/multi_quota_tree_affinity.go:37-113):
        when the pod's ElasticQuota belongs to a quota tree whose
        profile carries a node selector, inject that selector as
        REQUIRED node affinity, so tree pods stay on tree nodes even
        when other nodes score higher. The reference appends In
        requirements to every existing term (AND); in the dict selector
        model that is a key-wise merge, with a conflicting value
        resolving to an unsatisfiable sentinel — exactly as conflicting
        required In terms match no node."""
        quota_name = pod.quota or pod.namespace
        spec = self.quota_specs.get(quota_name)
        if spec is None:
            return
        tree_id = getattr(spec, "tree_id", "")
        if not tree_id:
            return
        selector = None
        for name in sorted(self.quota_profiles):
            profile = self.quota_profiles[name]
            if profile.effective_tree_id() == tree_id:
                selector = profile.node_selector
                break
        if not selector:
            return
        if pod.node_selector is None:
            pod.node_selector = dict(selector)
            return
        for key, value in selector.items():
            mine = pod.node_selector.get(key)
            if mine is not None and mine != value:
                pod.node_selector[key] = UNSATISFIABLE
            else:
                pod.node_selector[key] = value

    def _apply_recommendation(self, pod: PodSpec) -> None:
        """Right-size native requests from a covering Recommendation
        (before profile translation so batch/mid rewrites see the sized
        values). Limits only ever grow to keep limit >= request."""
        if self.recommendation_for is None:
            return
        recommended = self.recommendation_for(pod)
        if not recommended:
            return
        for res, value in recommended.items():
            if res not in pod.requests:
                continue  # only size resources the pod actually requests
            pod.requests[res] = int(value)
            if res in pod.limits and pod.limits[res] < pod.requests[res]:
                pod.limits[res] = pod.requests[res]

    def _apply_profile(self, pod: PodSpec, profile: ClusterColocationProfile) -> None:
        pod.labels.update(profile.labels)
        pod.annotations.update(profile.annotations)
        for key_new, key_old in profile.label_keys_mapping.items():
            if key_old in pod.labels:
                pod.labels[key_new] = pod.labels[key_old]
        for key_new, key_old in profile.annotation_keys_mapping.items():
            if key_old in pod.annotations:
                pod.annotations[key_new] = pod.annotations[key_old]
        if profile.qos_class is not None:
            pod.qos = profile.qos_class
        if profile.priority is not None:
            pod.priority = profile.priority
            pod.priority_class = priority_class_of(value=profile.priority)
        if profile.koordinator_priority is not None:
            pod.sub_priority = profile.koordinator_priority

    def _mutate_resource_spec(self, pod: PodSpec) -> None:
        """Translate native cpu/memory to the priority class's extended
        resources (mutatePodResourceSpec :238; replaceAndEraseResource).

        None/Prod pods keep native resources. BE/batch pods end up
        requesting batch-cpu/batch-memory — what the koord-manager
        overcommit calculator publishes on nodes.
        """
        priority_class = pod.priority_class or priority_class_of(
            value=pod.priority
        )
        if priority_class in (PriorityClass.NONE, PriorityClass.PROD):
            return
        for res in (pod.requests, pod.limits):
            for native in (ResourceName.CPU, ResourceName.MEMORY):
                extended = translate_resource_by_priority(native, priority_class)
                if extended == native:
                    continue
                if native in res:
                    res[extended] = res.pop(native)
        # restrictResourceRequestAndLimit: limit-only extended resources
        # gain a matching request
        for native in (ResourceName.CPU, ResourceName.MEMORY):
            extended = translate_resource_by_priority(native, priority_class)
            if extended == native:
                continue
            if extended in pod.limits and extended not in pod.requests:
                pod.requests[extended] = pod.limits[extended]
