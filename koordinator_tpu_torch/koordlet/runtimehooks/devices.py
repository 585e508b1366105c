"""Device hook: inject DeviceShare allocations into container env.

Reference: pkg/koordlet/runtimehooks/hooks/gpu/gpu.go — at
PreCreateContainer, parse the scheduler's device-allocation annotation
(``koordinator.sh/device-allocated``, written by the DeviceShare
plugin's PreBind — scheduler/plugins/deviceshare.py) and inject the
allocated device minors into the container's environment so the runtime
(device plugin / accelerator stack) actually confines the container to
its allocation. This is the actuation edge that makes the device
allocator's output land in a container.

The allocated GPU minors go to ``NVIDIA_VISIBLE_DEVICES`` (gpu.go:32
GpuAllocEnv), the variable a GPU container runtime reads, and the same
minors to ``TPU_VISIBLE_CHIPS``, which the reference writes too, so the
two packages' responses stay equal. RDMA VF bus ids ride
``KOORDINATOR_RDMA_VFS`` (the reference injects VFs through device
mounts; an env carrying bus ids is the runtime-agnostic equivalent).

Env injection is meaningful at container *creation* (NRI adjustment /
CRI-proxy request merge). In standalone reconcile mode the env response
is inert — a running container's environment cannot be changed — which
matches the reference (its gpu hook also only registers
PreCreateContainer).

Counterpart of ``koordinator_tpu/koordlet/runtimehooks/devices.py``:
host work in files, bit for bit the reference's.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from koordinator_tpu_torch.apis.extension import ANNOTATION_DEVICE_ALLOCATED
from koordinator_tpu_torch.device.cache import DeviceType
from koordinator_tpu_torch.koordlet.runtimehooks.hooks import HookRegistry, Stage
from koordinator_tpu_torch.koordlet.runtimehooks.protocol import ContainerContext

NAME = "DeviceEnvInject"

#: the reference's accelerator variable (libtpu's chip confinement)
TPU_ALLOC_ENV = "TPU_VISIBLE_CHIPS"
#: gpu.go:32 GpuAllocEnv: what a GPU container runtime reads
GPU_ALLOC_ENV = "NVIDIA_VISIBLE_DEVICES"
RDMA_VFS_ENV = "KOORDINATOR_RDMA_VFS"


def parse_device_allocations(
    annotations: Dict[str, str]
) -> Optional[Dict[str, List[dict]]]:
    """The PreBind allocation payload: {type: [{minor, resources, vfs?}]}
    (reference: ext.GetDeviceAllocations)."""
    raw = annotations.get(ANNOTATION_DEVICE_ALLOCATED)
    if not raw:
        return None
    try:
        alloc = json.loads(raw)
    except ValueError:
        return None
    return alloc if isinstance(alloc, dict) else None


class DeviceEnvPlugin:
    name = NAME

    def inject_container_device_env(self, proto) -> None:
        """gpu.go:51 InjectContainerGPUEnv, generalized per device type."""
        if not isinstance(proto, ContainerContext):
            return
        alloc = parse_device_allocations(proto.request.annotations)
        if not alloc:
            return
        # malformed annotation entries skip (error-and-continue, like the
        # JSON parse above) — raising here would fail container creation
        # on the proxy/NRI path
        minor_list = []
        gpu_entries = alloc.get(DeviceType.GPU.value) or []
        for d in gpu_entries if isinstance(gpu_entries, list) else []:
            try:
                minor_list.append(str(int(d.get("minor", 0))))
            except (TypeError, ValueError, AttributeError):
                continue
        minors = ",".join(minor_list)
        if minors:
            envs = proto.response.add_envs or {}
            envs[TPU_ALLOC_ENV] = minors
            envs[GPU_ALLOC_ENV] = minors
            proto.response.add_envs = envs
        vfs = []
        rdma_entries = alloc.get(DeviceType.RDMA.value) or []
        for d in rdma_entries if isinstance(rdma_entries, list) else []:
            try:
                entry_vfs = d.get("vfs") or []
            except AttributeError:
                continue
            if isinstance(entry_vfs, list):
                vfs.extend(str(v) for v in entry_vfs
                           if isinstance(v, (str, int)))
        if vfs:
            envs = proto.response.add_envs or {}
            envs[RDMA_VFS_ENV] = ",".join(vfs)
            proto.response.add_envs = envs

    def register(self, registry: HookRegistry) -> None:
        registry.register(
            Stage.PRE_CREATE_CONTAINER, self.name,
            "inject allocated device env into container",
            self.inject_container_device_env,
        )
