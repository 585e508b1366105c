"""NUMA topology hints + the four topology-manager merge policies.

Semantics oracle: pkg/scheduler/frameworkext/topologymanager/policy.go
(mergePermutation :86, filterProvidersHints :99, mergeFilteredHints :129),
policy_{none,best_effort,restricted,single_numa_node}.go, and
pkg/util/bitmask/bitmask.go (IsNarrowerThan :146). Affinities are plain
Python ints used as bitmasks over NUMA node ids (≤64 nodes).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class NUMATopologyPolicy(str, enum.Enum):
    """Pod/node NUMA alignment requirement (reference: apis/extension/
    numa_aware.go NUMATopologyPolicy)."""

    NONE = ""
    BEST_EFFORT = "BestEffort"
    RESTRICTED = "Restricted"
    SINGLE_NUMA_NODE = "SingleNUMANode"


@dataclasses.dataclass(frozen=True)
class NUMATopologyHint:
    """One provider hint: a NUMA-node bitmask + preference + weight
    (reference: topologymanager/policy.go NUMATopologyHint)."""

    affinity: Optional[int]  # bitmask over node ids; None = no preference
    preferred: bool = False
    score: int = 0


def mask_of(nodes: Iterable[int]) -> int:
    mask = 0
    for n in nodes:
        mask |= 1 << int(n)
    return mask


def mask_bits(mask: int) -> List[int]:
    out, i = [], 0
    while mask >> i:
        if (mask >> i) & 1:
            out.append(i)
        i += 1
    return out


def mask_count(mask: int) -> int:
    return bin(mask).count("1")


def _is_narrower(a: int, b: int) -> bool:
    """Fewer bits set wins; ties go to more lower-numbered bits
    (reference: bitmask.go IsNarrowerThan :146-151)."""
    if mask_count(a) == mask_count(b):
        return a < b
    return mask_count(a) < mask_count(b)


#: provider hints: per provider, resource name → list of hints (or None)
ProviderHints = Dict[str, Optional[List[NUMATopologyHint]]]


def _filter_providers_hints(
    providers_hints: Sequence[ProviderHints],
) -> List[List[NUMATopologyHint]]:
    """Normalize provider hints into per-resource hint lists (reference:
    filterProvidersHints policy.go:99-127): no hints at all → one preferred
    don't-care; a nil resource entry → preferred don't-care; an *empty*
    resource entry → unpreferred don't-care (provider cannot satisfy)."""
    out: List[List[NUMATopologyHint]] = []
    for hints in providers_hints:
        if not hints:
            out.append([NUMATopologyHint(None, True)])
            continue
        for resource in hints:
            if hints[resource] is None:
                out.append([NUMATopologyHint(None, True)])
            elif len(hints[resource]) == 0:
                out.append([NUMATopologyHint(None, False)])
            else:
                out.append(list(hints[resource]))
    return out


def _merge_permutation(
    default_affinity: int, permutation: Sequence[NUMATopologyHint]
) -> NUMATopologyHint:
    """Bitwise-AND one hint per provider; preferred iff all preferred and
    all set affinities equal (reference mergePermutation policy.go:86-96)."""
    preferred = True
    affinities = [h.affinity for h in permutation if h.affinity is not None]
    for h in permutation:
        if h.affinity is not None and h.affinity != affinities[0]:
            preferred = False
        if not h.preferred:
            preferred = False
    merged = default_affinity
    for a in affinities:
        merged &= a
    return NUMATopologyHint(merged, preferred, 0)


def _merge_filtered_hints(
    numa_nodes: Sequence[int], filtered: List[List[NUMATopologyHint]]
) -> NUMATopologyHint:
    """Cross-product merge, keep the narrowest preferred result
    (reference mergeFilteredHints policy.go:129-186)."""
    default_affinity = mask_of(numa_nodes)
    best = NUMATopologyHint(default_affinity, False, 0)
    for permutation in itertools.product(*filtered):
        merged = _merge_permutation(default_affinity, permutation)
        if merged.affinity == 0:
            continue
        score = merged.score
        for h in permutation:
            if h.affinity is not None and merged.affinity == h.affinity:
                score = max(score, h.score)
        merged = dataclasses.replace(merged, score=score)

        if merged.preferred and not best.preferred:
            best = merged
            continue
        if not merged.preferred and best.preferred:
            continue
        if not _is_narrower(merged.affinity, best.affinity):
            if (
                mask_count(merged.affinity) == mask_count(best.affinity)
                and merged.score > best.score
            ):
                best = merged
            continue
        best = merged
    return best


def merge_hints(
    policy: NUMATopologyPolicy,
    numa_nodes: Sequence[int],
    providers_hints: Sequence[ProviderHints],
) -> Tuple[NUMATopologyHint, bool]:
    """Merge all providers' hints under a policy → (best hint, admit).

    - NONE: no alignment, always admit (policy_none.go).
    - BEST_EFFORT: merged hint, always admit (policy_best_effort.go).
    - RESTRICTED: admit only if the merged hint is preferred
      (policy_restricted.go:40).
    - SINGLE_NUMA_NODE: only single-node or don't-care preferred hints
      participate; a whole-machine result degrades to don't-care
      (policy_single_numa_node.go:47-74).
    """
    if policy == NUMATopologyPolicy.NONE:
        return NUMATopologyHint(None, False, 0), True

    filtered = _filter_providers_hints(providers_hints)
    if policy == NUMATopologyPolicy.SINGLE_NUMA_NODE:
        filtered = [
            [
                h
                for h in hints
                if (h.affinity is None and h.preferred)
                or (
                    h.affinity is not None
                    and mask_count(h.affinity) == 1
                    and h.preferred
                )
            ]
            for hints in filtered
        ]
        best = _merge_filtered_hints(numa_nodes, filtered)
        if best.affinity == mask_of(numa_nodes):
            best = NUMATopologyHint(None, best.preferred, 0)
        return best, best.preferred

    best = _merge_filtered_hints(numa_nodes, filtered)
    if policy == NUMATopologyPolicy.RESTRICTED:
        return best, best.preferred
    return best, True  # BEST_EFFORT
