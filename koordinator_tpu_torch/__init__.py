"""koordinator-tpu on PyTorch and CUDA: the batched placement solver.

A second package beside ``koordinator_tpu`` (the JAX reference). Module
paths follow the reference so each counterpart is easy to find; the
port imports ``torch``, numpy and the standard library, never ``jax``
and nothing of ``koordinator_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without CUDA the default raises instead of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, which
    raises when this process has no CUDA device; an explicit device is
    taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
