"""The pipelined loop and the device observatory on the card (``cuda``:
skipped without an NVIDIA GPU).

This file imports no JAX, so it runs on a machine with a GPU and no JAX:
``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_loops_cuda.py``."""

import json
import os

import numpy as np
import pytest
import torch

from koordinator_tpu_torch import testing
from koordinator_tpu_torch.client import APIServer, Kind, wire_scheduler
from koordinator_tpu_torch.models.placement import PlacementModel
from koordinator_tpu_torch.obs.device import DEVICE_OBS
from koordinator_tpu_torch.scheduler.pipeline import TickPipeline
from koordinator_tpu_torch.scheduler.scheduler import Scheduler

pytestmark = pytest.mark.cuda

# the warm pool stays inert unless a test configures its store, as
# tests/conftest.py keeps it for the CPU suite (these files also run
# under --noconftest, where a default store in the home directory
# would restore earlier runs' entries and count their launches)
os.environ.setdefault("KTPU_COMPILATION_CACHE_DIR", "")

NODES = 200


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _loop(mode, device=None, ticks=6, on_round=None):
    """Config #13's stream at NODES nodes through the serial or the
    pipelined loop on ``device`` (the card unless given): the per-tick
    placements."""
    bus = APIServer()
    sched = Scheduler(model=PlacementModel(device=device))
    wire_scheduler(bus, sched)
    testing.loop_world(bus, Kind, NODES)
    rng = np.random.default_rng(7)
    log = []
    pipeline = None
    if mode == "pipelined":
        pipeline = TickPipeline(sched, log=lambda *a: None,
                                on_result=lambda o: log.append(sorted(o.items())))
    testing.loop_tick(bus, Kind, rng, 0, 20.0, NODES, dirty=20, pending=32)
    for t in range(ticks):
        now = 20.0 + t
        if on_round is not None:
            on_round(t)
        if pipeline is None:
            log.append(sorted(sched.schedule_pending(now=now).items()))
        else:
            pipeline.submit_round(now=now)
        if t + 1 < ticks:
            # the next tick's arrivals land while this tick is in flight
            testing.loop_tick(bus, Kind, rng, t + 1, now + 1.0, NODES,
                              dirty=20, pending=32)
        if pipeline is not None:
            pipeline.prestage(now=now)
    if pipeline is not None:
        pipeline.drain("test")
        pipeline.stop()
    return log, sched


def test_pipelined_equals_serial_on_the_card():
    _needs_gpu()
    piped, sched = _loop("pipelined")
    serial, _ = _loop("serial")
    cpu, _ = _loop("serial", device="cpu")
    assert len(piped) == 6
    assert piped == serial == cpu
    assert sched.model.last_solver == "kernel"
    assert sched.model.staged_cache.last_path == "delta"


def test_profile_window_holds_the_kernel_launches(tmp_path):
    _needs_gpu()
    DEVICE_OBS.reset()
    DEVICE_OBS.configure(profile_dir=str(tmp_path), profile_min_interval_s=0.0)
    try:
        armed = {}

        def on_round(t):
            if t == 1:
                armed.update(DEVICE_OBS.request_profile(rounds=3))

        _loop("pipelined", on_round=on_round)
        assert armed["device"] == "cuda"
        profile = DEVICE_OBS.status()["profile"]
        assert profile["last_error"] is None and len(profile["windows"]) == 1
        events = json.loads(open(profile["windows"][0]).read())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        assert sum("binpack_kernel" in e["name"] for e in kernels) >= 3
        names = {e.get("name") for e in events}
        assert {"ktpu:device_solve", "ktpu:prestage"} <= names
    finally:
        DEVICE_OBS.reset()


def test_live_bytes_include_the_staged_cache():
    _needs_gpu()
    _log, sched = _loop("serial", ticks=2)
    live = DEVICE_OBS.live_snapshot()
    staged = sched.model.staged_cache.device_bytes()
    assert live["owners"]["staged_cache"] == staged > 0
    assert live["bytes"] >= staged
    assert live["reserved_bytes"] >= live["bytes"]
    assert live["max_allocated_bytes"] >= live["bytes"]
    assert live["count"] > 0 and live["alloc_retries"] >= 0
