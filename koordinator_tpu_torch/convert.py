"""Carry the reference package's solver state across to the port.

A scheduler has no weights: what carries across is solver state. Each
function takes one of the reference's NamedTuples (``NodeState``,
``PodBatch``, ``ScoreParams``, ``QuotaState``, ``GangState``,
``ResvArrays``, ``NumaAux``, and ``ops/preempt.py``'s ``ResidentWorld``
and ``PreemptorBatch``) as a dict of numpy arrays, ``{k:
np.asarray(v) for k, v in s._asdict().items()}``, and builds the port's
counterpart on ``device`` (``cuda`` unless the caller passes one, as
every entry point of the port). Values are taken as they are (the
reference's ``build`` already saturated and normalized them). A field
the port does not know raises.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Type

import numpy as np
import torch

from koordinator_tpu_torch import DeviceLike, resolve_device
from koordinator_tpu_torch.ops.binpack import (
    NodeState,
    NumaAux,
    PodBatch,
    ResvArrays,
    ScoreParams,
)
from koordinator_tpu_torch.ops.gang import GangState
from koordinator_tpu_torch.ops.preempt import PreemptorBatch, ResidentWorld
from koordinator_tpu_torch.ops.quota import QuotaState


def _is_none(v) -> bool:
    # np.asarray(None) is a 0-d object array holding None
    return v is None or (isinstance(v, np.ndarray) and v.dtype == object
                         and v.ndim == 0 and v.item() is None)


def _build(cls: Type[NamedTuple], d: Mapping, device: DeviceLike) -> NamedTuple:
    device = resolve_device(device)
    extra = [k for k in d if k not in cls._fields and not _is_none(d[k])]
    if extra:
        raise ValueError(f"{cls.__name__} has no fields {extra}")
    return cls(**{
        f: None if _is_none(d[f]) else torch.as_tensor(np.array(d[f]),
                                                       device=device)
        for f in cls._fields if f in d
    })


def node_state(d: Mapping, device: DeviceLike = None) -> NodeState:
    return _build(NodeState, d, device)


def pod_batch(d: Mapping, device: DeviceLike = None) -> PodBatch:
    return _build(PodBatch, d, device)


def score_params(d: Mapping, device: DeviceLike = None) -> ScoreParams:
    return _build(ScoreParams, d, device)


def quota_state(d: Mapping, device: DeviceLike = None) -> QuotaState:
    return _build(QuotaState, d, device)


def gang_state(d: Mapping, device: DeviceLike = None) -> GangState:
    return _build(GangState, d, device)


def resv_arrays(d: Mapping, device: DeviceLike = None) -> ResvArrays:
    return _build(ResvArrays, d, device)


def numa_aux(d: Mapping, device: DeviceLike = None) -> NumaAux:
    return _build(NumaAux, d, device)


def resident_world(d: Mapping, device: DeviceLike = None) -> ResidentWorld:
    return _build(ResidentWorld, d, device)


def preemptor_batch(d: Mapping, device: DeviceLike = None) -> PreemptorBatch:
    return _build(PreemptorBatch, d, device)
