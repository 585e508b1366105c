"""Node-sharded solves (counterpart of ``koordinator_tpu/parallel/mesh.py``).

The reference shards the node axis over the chips of a mesh. On one
H100 the counterpart of a shard is a CTA of a thread-block cluster:
:func:`shard_kernel_solver` runs the reference's array-level entry of the
same name on the cluster kernel (``csrc/binpack_cluster.cu``), k CTAs
of one cluster, one node shard each, with the per-pod winner merged
through distributed shared memory.

Ported here: the bucket helpers (:func:`pow2_quarter_bucket`,
:func:`shard_node_bucket`, :func:`shard_tile_bucket`, pure integer
functions kept as the port's own copies) and :func:`shard_kernel_solver`,
with :func:`cluster_kernel_supported` in the place of
``distributed_kernel_supported``. The GSPMD solvers (``shard_solver``,
``shard_full_solver``, ``shard_lane_solver``, ``stack_pod_lanes``) and
``pad_node_arrays`` are not ported yet.
"""

from __future__ import annotations

import torch

from koordinator_tpu_torch import DeviceLike, resolve_device
from koordinator_tpu_torch.ops.binpack import (
    NodeState,
    NumaAux,
    SolveResult,
    SolverConfig,
)


def pow2_quarter_bucket(n: int, floor: int = 8) -> int:
    """Round ``n`` up to a quarter step between powers of two (at least
    ``floor``): the repo's shape-bucket family."""
    if n <= floor:
        return floor
    power = 1 << (n - 1).bit_length()
    step = max(1, power // 8)
    return ((n + step - 1) // step) * step


def shard_node_bucket(n: int, shards: int) -> int:
    """The padded global node count for ``n`` real nodes over ``shards``
    shards: each shard's width is the quarter-step bucket of
    ``ceil(n / shards)``, every shard equal-width."""
    if shards <= 1:
        return n
    return pow2_quarter_bucket(-(-n // shards)) * shards


def shard_tile_bucket(n: int, shards: int) -> int:
    """The padded global node count of the sharded kernel: each shard's
    width is ``ceil(n / shards)`` rounded up to 128 rows, every shard
    equal-width (the reference's 128-lane tiles; the cluster kernel keeps
    the layout so shard boundaries fall where the reference's do)."""
    local = ((n + 128 * shards - 1) // (128 * shards)) * 128
    return local * shards


def cluster_kernel_supported(shards: int, device: DeviceLike = None) -> bool:
    """Whether :func:`shard_kernel_solver` can run ``shards`` node shards
    on ``device``: on a CUDA device, whether a cluster of that many CTAs
    of the cluster kernel (its threads, registers and shared memory) can
    be resident (``cudaOccupancyMaxActiveClusters`` > 0, for every
    instance); on the CPU, the plain twin takes any 2..16."""
    from koordinator_tpu_torch.ops import binpack_kernel as bk

    device = resolve_device(device)
    if not 2 <= shards <= bk.MAX_SHARDS:
        return False
    if device.type == "cpu":
        return True
    return bk.cluster_occupancy(shards, device) > 0


def _pad_rows(a, n_pad):
    if a is None:
        return None
    return torch.cat([a, a.new_zeros((n_pad - a.shape[0],) + a.shape[1:])])


def shard_kernel_solver(shards: int, config: SolverConfig = SolverConfig(),
                        device: DeviceLike = None):
    """The placement kernel over ``shards`` node shards: the CTAs of one
    thread-block cluster on a CUDA device (``shards`` 2..16; one shard
    is the one-block kernel of ``kernel_solve_batch``), the cluster
    kernel's plain twin on the CPU.

    Returns ``solve(state, pods, params, quota_state=None,
    gang_state=None, numa_aux=None, resv=None) -> SolveResult``, equal
    to the single-device ``solve_batch`` on every output, tie-breaks
    included (the packed key carries the global node index). The node
    axis is padded with unschedulable zero rows to
    :func:`shard_tile_bucket` and the padding trimmed off ``node_state``.
    The quota runtime is water-filled once per solve; the gang epilogue
    is the one-block kernel's. Raises ``ValueError`` where the reference
    does: a configuration the kernel does not take, more than 65,536
    padded nodes, an empty reservation table (pass None), a table whose
    credit could overflow the packed key's score budget. Raises
    ``RuntimeError`` when a cluster of ``shards`` CTAs cannot be resident
    on the device; it never falls back to another kernel or the twin.
    The inputs must lie on ``device``."""
    from koordinator_tpu_torch.ops import binpack_kernel as bk

    if not 2 <= shards <= bk.MAX_SHARDS:
        raise ValueError(f"shards must be 2..{bk.MAX_SHARDS}, got {shards} "
                         "(one shard is kernel_solve_batch)")
    device = resolve_device(device)
    resident = []   # the cluster answer, asked once

    def solve(state: NodeState, pods, params, quota_state=None,
              gang_state=None, numa_aux=None, resv=None) -> SolveResult:
        if not bk.kernel_supported(params, config):
            raise ValueError("configuration not supported by the kernel")
        n = state.alloc.shape[0]
        n_pad = shard_tile_bucket(n, shards)
        if n_pad > bk.MAX_NODES:
            raise ValueError("packed argmax carries 16 lane bits: "
                             f"{n} nodes pad to {n_pad} over {shards} shards")
        if resv is not None:
            if not bk.kernel_resv_supported(int(resv.node.shape[0])):
                raise ValueError("an empty reservation table is passed as "
                                 "None")
            if not bk.kernel_resv_score_safe(resv.node, resv.free,
                                             state.alloc):
                raise ValueError("reservation credit could overflow the "
                                 "packed key's 15-bit score budget: use the "
                                 "loop solver")
        if not resident:
            resident.append(cluster_kernel_supported(shards, device))
        if not resident[0]:
            raise RuntimeError(f"a cluster of {shards} CTAs of the placement "
                               f"kernel cannot be resident on {device}")
        if state.alloc.device.type != device.type:
            raise ValueError(f"inputs on {state.alloc.device}, solver on "
                             f"{device}")
        padded = NodeState(*(_pad_rows(a, n_pad) for a in state))
        aux = (None if numa_aux is None
               else NumaAux(_pad_rows(numa_aux.node_policy, n_pad)))
        out = bk.binpack_sharded(
            bk.kernel_inputs(padded, pods, params,
                             bk.quota_inputs(quota_state), numa_aux=aux,
                             resv=resv,
                             most_allocated=config.numa_most_allocated),
            shards)
        result = bk.kernel_result(padded, out, pods, quota_state, gang_state,
                                  numa_aux is not None, resv is not None)
        return result._replace(node_state=NodeState(
            *(None if a is None else a[:n] for a in result.node_state)))

    return solve
