"""The port's own copies of ``numa/`` and ``device/`` against the JAX
package's, on seeded inputs: ``take_cpus`` over seeded topologies,
allocations and policies; the hint merge under every policy; the NUMA
resource manager's allocate, update and release; and the device
allocator's joint allocate and score."""

import importlib

import numpy as np
import pytest


def _mods(root):
    return {name: importlib.import_module(f"{root}.{name}") for name in (
        "numa.topology", "numa.accumulator", "numa.hints", "numa.manager",
        "device.cache", "device.allocator", "apis.extension")}


REF, PORT = _mods("koordinator_tpu"), _mods("koordinator_tpu_torch")


def _take(m, rng_seed, shape, max_ref):
    """One seeded ``take_cpus`` call in package ``m``: the result or the
    error's type name."""
    topo_mod, acc = m["numa.topology"], m["numa.accumulator"]
    rng = np.random.default_rng(rng_seed)
    topo = topo_mod.CPUTopology.build(*shape)
    c = topo.num_cpus
    available = rng.uniform(size=c) < 0.7
    ref_count = np.where(available, rng.integers(0, max_ref + 1, c), 0)
    allocated = topo_mod.AllocatedCPUs(
        ref_count=ref_count.astype(np.int32),
        exclusive_in_cores={int(x) for x in rng.choice(
            c // shape[3], 2, replace=False)} if rng.random() < 0.5 else set(),
        exclusive_in_numa_nodes={0} if rng.random() < 0.2 else set())
    need = int(rng.integers(1, c + 1))
    bind = list(topo_mod.CPUBindPolicy)[int(rng.integers(0, 4))]
    excl = list(topo_mod.CPUExclusivePolicy)[int(rng.integers(0, 3))]
    strategy = list(topo_mod.NUMAAllocateStrategy)[int(rng.integers(0, 2))]
    try:
        out = acc.take_cpus(topo, max_ref, available, allocated, need, bind,
                            excl, strategy)
        return [int(x) for x in out]
    except acc.CPUAllocationError as e:
        return ("CPUAllocationError", str(e))


@pytest.mark.parametrize("shape", [(1, 1, 4, 2), (2, 1, 8, 2), (2, 2, 4, 2),
                                   (4, 1, 6, 1)])
def test_take_cpus_matches_reference(shape):
    seen = set()
    for seed in range(40):
        max_ref = 1 + seed % 2
        want = _take(REF, seed, shape, max_ref)
        got = _take(PORT, seed, shape, max_ref)
        assert got == want, (shape, seed)
        seen.add(isinstance(want, tuple))
    assert seen == {True, False}   # both outcomes reached


def _hints(m, rng, n_nodes):
    hints = m["numa.hints"]
    providers = []
    for _ in range(int(rng.integers(1, 4))):
        prov = {}
        for res in ("cpu", "memory"):
            if rng.random() < 0.15:
                prov[res] = None
                continue
            prov[res] = [hints.NUMATopologyHint(
                int(rng.integers(1, 1 << n_nodes)), bool(rng.random() < 0.6),
                int(rng.integers(0, 100)))
                for _ in range(int(rng.integers(0, 4)))]
        providers.append(prov)
    return providers


@pytest.mark.parametrize("policy", ["", "BestEffort", "Restricted",
                                    "SingleNUMANode"])
def test_merge_hints_matches_reference(policy):
    for seed in range(60):
        n_nodes = 1 + seed % 4
        out = []
        for m in (REF, PORT):
            rng = np.random.default_rng(seed)
            hints = m["numa.hints"]
            best, admit = hints.merge_hints(
                hints.NUMATopologyPolicy(policy), list(range(n_nodes)),
                _hints(m, rng, n_nodes))
            out.append((best.affinity, best.preferred, best.score, admit))
        assert out[0] == out[1], (policy, seed)


def _manager_run(m, seed):
    """A ResourceManager with two seeded topologies: a sequence of
    allocate (+ update) and release calls; the allocations made and the
    final available resources, as plain data."""
    mgr_mod, topo_mod, hints = m["numa.manager"], m["numa.topology"], \
        m["numa.hints"]
    R = m["apis.extension"].ResourceName
    rng = np.random.default_rng(seed)
    mgr = mgr_mod.ResourceManager()
    for name in ("a", "b"):
        mgr.update_topology(name, mgr_mod.TopologyOptions(
            cpu_topology=topo_mod.CPUTopology.build(2, 1, 4, 2),
            policy=hints.NUMATopologyPolicy("BestEffort"),
            numa_node_resources={k: {R.CPU: 8000, R.MEMORY: 16384}
                                 for k in (0, 1)}))
    log = []
    held = []
    for step in range(24):
        node = ("a", "b")[int(rng.integers(0, 2))]
        if held and rng.random() < 0.3:
            n, uid = held.pop(int(rng.integers(0, len(held))))
            mgr.release(n, uid)
            log.append(("release", n, uid))
            continue
        uid = f"p{step}"
        cpus = int(rng.integers(1, 5))
        bind = bool(rng.random() < 0.6)
        opts = mgr_mod.ResourceOptions(
            requests={R.CPU: cpus * 1000, R.MEMORY: int(rng.integers(512,
                                                                    8192))},
            num_cpus_needed=cpus, request_cpu_bind=bind,
            cpu_bind_policy=list(topo_mod.CPUBindPolicy)[int(rng.integers(
                0, 3))],
            hint=hints.NUMATopologyHint(
                int(rng.integers(1, 4)) if rng.random() < 0.5 else None,
                True, 0))
        try:
            alloc = mgr.allocate(node, uid, opts)
        except m["numa.accumulator"].CPUAllocationError as e:
            log.append(("error", node, uid, str(e)))
            continue
        mgr.update(node, alloc)
        held.append((node, uid))
        log.append(("alloc", node, uid, [int(c) for c in alloc.cpuset],
                    {k: {int(r): v for r, v in res.items()}
                     for k, res in alloc.numa_resources.items()}))
    for node in ("a", "b"):
        avail, _ = mgr.available_numa_resources(node)
        log.append(("available", node, {k: {int(r): v for r, v in res.items()}
                                        for k, res in avail.items()}))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resource_manager_matches_reference(seed):
    want, got = _manager_run(REF, seed), _manager_run(PORT, seed)
    assert got == want
    assert any(e[0] == "alloc" and e[3] for e in got)


def _device_run(m, seed):
    """Seeded node devices (GPUs and RDMA on two PCIe switches and two
    NUMA nodes), then a sequence of pod requests: for each, the
    allocator's allocation (applied) or its error, and its score."""
    dc, da = m["device.cache"], m["device.allocator"]
    DR, DT = dc.DeviceResourceName, dc.DeviceType
    rng = np.random.default_rng(seed)
    entries = []
    for i in range(8):
        entries.append(dc.DeviceEntry(
            minor=i, device_type=DT.GPU,
            resources={DR.GPU_CORE: 100, DR.GPU_MEMORY: 16384,
                       DR.GPU_MEMORY_RATIO: 100},
            numa_node=i // 4, pcie_id=str(i // 2),
            health=bool(rng.random() > 0.1)))
    for i in range(2):
        entries.append(dc.DeviceEntry(
            minor=i, device_type=DT.RDMA, resources={DR.RDMA: 100},
            numa_node=i, pcie_id=str(2 * i),
            vfs=[dc.VirtualFunction(bus_id=f"0000:{i}:{k}", minor=k)
                 for k in range(4)]))
    node = dc.NodeDevice("n", entries)
    out = []
    for step in range(20):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            raw = {DR.NVIDIA_GPU: int(rng.integers(1, 4))}
        elif kind == 1:
            raw = {DR.GPU_CORE: int(rng.choice([25, 50, 100])),
                   DR.GPU_MEMORY_RATIO: int(rng.choice([25, 50, 100]))}
        elif kind == 2:
            raw = {DR.KOORD_GPU: int(rng.choice([50, 100, 200]))}
        else:
            raw = {DR.NVIDIA_GPU: 1, DR.RDMA: 100}
        joint = None
        if kind == 3 and rng.random() < 0.5:
            joint = da.JointAllocate(device_types=[DT.GPU, DT.RDMA],
                                     required_scope="SamePCIe")
        affinity = int(rng.integers(1, 4)) if rng.random() < 0.3 else None
        try:
            requests = da.normalize_device_requests(raw)
            alloc = da.AutopilotAllocator(
                node, requests, joint_allocate=joint, numa_affinity=affinity,
                scorer=("LeastAllocated", "MostAllocated")[step % 2])
            score = alloc.score()
            got = alloc.allocate()
        except da.DeviceUnschedulable as e:
            out.append(("unschedulable", str(e)))
            continue
        node.apply(f"p{step}", got)
        out.append((score, {t.value: [(a.minor, {k.value: v for k, v in
                                                 a.resources.items()},
                                       list(a.vf_bus_ids)) for a in allocs]
                            for t, allocs in got.items()}))
        if rng.random() < 0.25:
            node.release(f"p{int(rng.integers(0, step + 1))}")
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_allocator_matches_reference(seed):
    want, got = _device_run(REF, seed), _device_run(PORT, seed)
    assert got == want
    assert {isinstance(e[0], str) for e in got} == {True, False}
