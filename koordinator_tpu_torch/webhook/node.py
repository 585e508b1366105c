"""Node admission: resource-amplification mutation + validation.

The port's copy of ``koordinator_tpu/webhook/node.py``, equal to it bit for
bit (held by ``tests/test_torch_*.py`` on the same inputs).

Reference: pkg/webhook/node/ — the mutating handler's
resourceamplification plugin (resource_amplification.go) intercepts node
UPDATEs: when the kubelet changed raw cpu/memory allocatable on a node
carrying an amplification-ratio annotation, it re-records the raw
capacity annotation and amplifies the visible allocatable, so the
scheduler keeps seeing normalized numbers; the validating handler guards
the annotation protocol itself.
"""

from __future__ import annotations

import json
import math
from typing import List, Optional

from koordinator_tpu_torch.apis.extension import (
    ANNOTATION_NODE_RAW_ALLOCATABLE,
    ANNOTATION_RESOURCE_AMPLIFICATION_RATIO,
    ResourceName,
)
from koordinator_tpu_torch.apis.types import NodeSpec

#: only cpu/memory amplify (resource_amplification.go supportedResources)
SUPPORTED = (ResourceName.CPU, ResourceName.MEMORY)


def parse_ratios(node: NodeSpec) -> Optional[dict]:
    raw = node.annotations.get(ANNOTATION_RESOURCE_AMPLIFICATION_RATIO)
    if not raw:
        return None
    ratios = json.loads(raw)
    if not isinstance(ratios, dict):
        raise ValueError("amplification ratio annotation must be a "
                         "JSON object of resource -> ratio")
    return {str(k): float(v) for k, v in ratios.items()}


def stored_raw_allocatable(node: NodeSpec) -> Optional[dict]:
    """The recorded raw capacity: the typed field when present, else
    parsed back from the annotation — raw state must survive
    serialization (the reference reads the annotation, never memory)."""
    if node.raw_allocatable is not None:
        return dict(node.raw_allocatable)
    text = node.annotations.get(ANNOTATION_NODE_RAW_ALLOCATABLE)
    if not text:
        return None
    try:
        parsed = json.loads(text)
    except ValueError:
        return None
    if not isinstance(parsed, dict):
        return None
    out = {}
    for key, value in parsed.items():
        for r in SUPPORTED:
            if key in (r.name.lower(), str(int(r))):
                try:
                    out[r] = int(value)
                except (ValueError, TypeError):
                    # corrupt annotation: treat as never-recorded — a
                    # bad value must not crash admission
                    return None
    return out or None


class NodeMutatingWebhook:
    """Amplification admit (resource_amplification.go Admit)."""

    def mutate(self, node: NodeSpec,
               old_node: Optional[NodeSpec] = None) -> NodeSpec:
        """CREATE passes through (reference: Create -> nil); on UPDATE
        with a ratio annotation, a raw cpu/memory allocatable change is
        re-amplified and the raw values recorded."""
        if old_node is None:
            return node
        try:
            ratios = parse_ratios(node)
        except (ValueError, TypeError):
            return node  # validation rejects; never half-mutate
        if not ratios:
            # amplification disabled: drop the stale raw record
            # (reference handleUpdate deletes the annotation here)
            node.annotations.pop(ANNOTATION_NODE_RAW_ALLOCATABLE, None)
            node.raw_allocatable = None
            return node
        # reference semantics: record raw when it was never recorded OR
        # the kubelet changed the supported resources; otherwise
        # re-amplify from the STORED raw — an echoed amplified value (or
        # a ratio change alone) must never compound
        changed = any(
            node.allocatable.get(r) != old_node.allocatable.get(r)
            for r in SUPPORTED
        )
        stored = stored_raw_allocatable(old_node)
        if changed or stored is None:
            raw = dict(node.allocatable)
        else:
            raw = stored
        node.raw_allocatable = raw
        # one shared encoding with the manager's cpu-normalization
        # plugin: lowercase resource names
        node.annotations[ANNOTATION_NODE_RAW_ALLOCATABLE] = json.dumps(
            {r.name.lower(): raw[r] for r in SUPPORTED if r in raw}
        )
        for r in SUPPORTED:
            ratio = ratios.get(str(int(r)), ratios.get(r.name.lower()))
            if ratio and math.isfinite(ratio) and r in raw:
                node.allocatable[r] = int(raw[r] * ratio)
        return node


class NodeValidatingWebhook:
    """Annotation-protocol guard (pkg/webhook/node/validating scope)."""

    def validate(self, node: NodeSpec,
                 old_node: Optional[NodeSpec] = None) -> List[str]:
        violations: List[str] = []
        try:
            ratios = parse_ratios(node)
        except (ValueError, TypeError) as e:
            return [f"malformed amplification ratio annotation: {e}"]
        if ratios:
            for key, ratio in ratios.items():
                # the explicit range also rejects NaN (all comparisons
                # False) and infinity; the 100x cap matches the
                # normalization guard protecting the int32 capacity
                # columns (manager/noderesource._MAX_NORMALIZATION_RATIO)
                if not 1.0 <= ratio <= 100.0:
                    violations.append(
                        f"amplification ratio for {key} must be in "
                        f"[1.0, 100.0], got {ratio}"
                    )
        return violations
