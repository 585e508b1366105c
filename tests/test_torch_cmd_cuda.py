"""The binaries and the auditor on the card (``cuda``: skipped without an
NVIDIA GPU).

``cmd/scheduler.main --once`` on ``cuda`` against the same binary on the
CPU, and an auditor sweep whose parity probe reads staged rows back from
the card: clean after a round, then a drifted CUDA row (and only that
row) detected as device drift, restaged, and the next round equal to a
clean run's. This file imports no JAX, so it runs on a machine with a GPU
and no JAX: ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cmd_cuda.py``."""

import json
import os

import pytest
import torch

from koordinator_tpu_torch.apis.extension import ResourceName
from koordinator_tpu_torch.apis.types import PodSpec
from koordinator_tpu_torch.client import APIServer, Kind, wire_scheduler
from koordinator_tpu_torch.cmd import scheduler as cmd
from koordinator_tpu_torch.cmd.scheduler import SchedulerConfig, build_scheduler
from koordinator_tpu_torch.ops import binpack_kernel as bk
from koordinator_tpu_torch.scheduler.auditor import StateAuditor

pytestmark = pytest.mark.cuda

# the warm pool stays inert unless a test configures its store, as
# tests/conftest.py keeps it for the CPU suite (these files also run
# under --noconftest, where a default store in the home directory
# would restore earlier runs' entries and count their launches)
os.environ.setdefault("KTPU_COMPILATION_CACHE_DIR", "")


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _cluster_json(tmp_path, n_nodes=1200, n_pods=2000):
    path = tmp_path / "cluster.json"
    path.write_text(json.dumps({
        "nodes": [{"name": f"n{i}", "cpu": 32000 + 16 * i,
                   "memory": 65536 + 32 * i} for i in range(n_nodes)],
        "pods": [{"name": f"p{j}", "cpu": 200 + (j * 37) % 3000,
                  "memory": 128 + (j * 53) % 4096} for j in range(n_pods)],
    }))
    return str(path)


def _main_round(path, device, capsys):
    rc = cmd.main(["--once", "--cluster-json", path, "--device", device])
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("round:")]
    return rc, lines


def test_scheduler_main_once_on_the_card(tmp_path, capsys):
    _needs_gpu()
    path = _cluster_json(tmp_path)
    for kind in bk.LAUNCHES:
        bk.LAUNCHES[kind] = 0
    rc, lines = _main_round(path, "cuda", capsys)
    launched = sum(bk.LAUNCHES.values())
    assert rc == 0 and launched >= 1, bk.LAUNCHES
    assert _main_round(path, "cpu", capsys) == (rc, lines)
    assert lines and lines[0].startswith("round: 2000/2000 placed")


def _wired(device, path):
    bus = APIServer()
    sched = build_scheduler(SchedulerConfig(), device=device)
    wire_scheduler(bus, sched)
    cmd.seed_bus_from_json(bus, path)
    return bus, sched


def test_sweep_reads_cuda_rows_and_repairs_device_drift(tmp_path):
    _needs_gpu()
    path = _cluster_json(tmp_path, n_nodes=300, n_pods=400)
    bus, sched = _wired("cuda", path)
    aud = StateAuditor(sched, bus, interval_rounds=0, probe_rows=300)
    sched.schedule_pending(now=100.0)
    sched.schedule_pending(now=100.0)   # settles the bind-dirty rows
    state = sched.model.staged_cache.audit_view()[1]
    assert state.usage.device.type == "cuda"
    clean = aud.sweep("manual", now=100.0)
    assert clean["detections"] == {} and len(clean["probe_rows"]) == 300
    assert clean["readback_s"] > 0.0
    # drift one staged CUDA row, and only it: the host arrays are copies
    arrays = sched.model.staged_cache.arrays
    host_before = arrays.used_req[7].copy()
    state.used_req[7, 0] += 999
    assert (arrays.used_req[7] == host_before).all()
    drifted = aud.sweep("manual", now=100.0)
    assert drifted["detections"] == {"device-parity/staged-device-drift": 1}
    assert drifted["repairs"] == {"full-restage": 1}
    assert drifted["probe_rows"][7] == arrays.names[7]
    # the next round restages from truth and equals a clean run's
    fresh_bus, fresh = _wired("cuda", path)
    fresh.schedule_pending(now=100.0)
    fresh.schedule_pending(now=100.0)
    got = _round_of_arrivals(bus, sched)
    assert sched.model.staged_cache.last_path == "full"
    assert got == _round_of_arrivals(fresh_bus, fresh)
    assert sum(n is not None for n in got.values()) > 0
    assert aud.sweep("manual", now=101.0)["detections"] == {}


def _round_of_arrivals(bus, sched):
    """Sixty pods arrive; one round at t = 101."""
    for j in range(60):
        pod = PodSpec(name=f"late{j}", requests={
            ResourceName.CPU: 900 + 131 * j, ResourceName.MEMORY: 512})
        bus.apply(Kind.POD, pod.uid, pod)
    return dict(sched.schedule_pending(now=101.0))
