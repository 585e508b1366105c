"""Peak prediction server: ingests usage samples, serves peak estimates.

The port's copy of ``koordinator_tpu/koordlet/prediction/predict_server.py``, equal to it bit for
bit (held by ``tests/test_torch_*.py`` on the same inputs).

Reference: pkg/koordlet/prediction/predict_server.go — one decaying
histogram per (subject, resource); subjects are pods (uid), priority
classes, and the system residual. Checkpointed to disk
(checkpoint.go) so restarts keep history.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

from koordinator_tpu_torch.koordlet.prediction.histogram import HistogramBank


@dataclasses.dataclass
class PredictionConfig:
    """Reference: prediction/config.go:40-42."""

    safety_margin_percent: int = 10
    cpu_half_life_seconds: float = 12 * 3600
    memory_half_life_seconds: float = 24 * 3600
    cold_start_seconds: float = 15 * 60
    checkpoint_path: str = ""


#: subject key helpers (reference: UIDType / UIDGenerator)
def pod_key(uid: str) -> str:
    return f"pod/{uid}"


def priority_key(priority_class: str) -> str:
    return f"priority/{priority_class}"


SYS_KEY = "sys"
NODE_KEY = "node"


class PeakPredictServer:
    """Histogram banks + checkpoint (reference: predict_server.go:65)."""

    def __init__(self, config: Optional[PredictionConfig] = None):
        self.config = config or PredictionConfig()
        self.cpu = HistogramBank(
            first_bucket=25.0,  # mCPU (reference: 0.025 cores)
            half_life_seconds=self.config.cpu_half_life_seconds,
        )
        self.memory = HistogramBank(
            first_bucket=5.0,  # MiB (reference: 5 MiB)
            half_life_seconds=self.config.memory_half_life_seconds,
        )

    def update(self, key: str, cpu_mcpu: float, mem_mib: float,
               now: float) -> None:
        self.cpu.add(key, cpu_mcpu, now)
        self.memory.add(key, mem_mib, now)

    def peak(self, key: str, cpu_p: float = 0.95,
             mem_p: float = 0.98) -> Dict[str, Optional[float]]:
        """Peak estimate with the safety margin applied (reference:
        peak_predictor.go:176-193: p95 cpu / p98 memory, each scaled by
        (100 + margin)/100)."""
        ratio = (100 + self.config.safety_margin_percent) / 100.0
        cpu = self.cpu.percentile(key, cpu_p)
        mem = self.memory.percentile(key, mem_p)
        return {
            "cpu": cpu * ratio if cpu is not None else None,
            "memory": mem * ratio if mem is not None else None,
        }

    def peaks_batch(self, keys: Sequence[str], cpu_p: float = 0.95,
                    mem_p: float = 0.98) -> List[Dict[str, Optional[float]]]:
        ratio = (100 + self.config.safety_margin_percent) / 100.0
        cpus = self.cpu.percentiles_batch(keys, [cpu_p])
        mems = self.memory.percentiles_batch(keys, [mem_p])
        return [
            {
                "cpu": c[0] * ratio if c[0] is not None else None,
                "memory": m[0] * ratio if m[0] is not None else None,
            }
            for c, m in zip(cpus, mems)
        ]

    def in_cold_start(self, key: str, now: float) -> bool:
        """Pods younger than the cold-start window are not reclaimable
        (peak_predictor.go coldStartDuration check)."""
        first = self.cpu.first_seen(key)
        return first is None or now - first < self.config.cold_start_seconds

    def gc(self, live_keys: Sequence[str]) -> None:
        keep = set(live_keys) | {SYS_KEY, NODE_KEY}
        keep |= {k for k in (priority_key("prod"), priority_key("mid"),
                             priority_key("batch"), priority_key("free"))}
        self.cpu.forget(keep)
        self.memory.forget(keep)

    # -- checkpoint (reference: prediction/checkpoint.go) --------------------

    def save_checkpoint(self, path: Optional[str] = None) -> None:
        path = path or self.config.checkpoint_path
        if not path:
            return
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"cpu": self.cpu.state(),
                       "memory": self.memory.state()}, f)
        os.replace(tmp, path)

    def load_checkpoint(self, path: Optional[str] = None) -> bool:
        path = path or self.config.checkpoint_path
        if not path or not os.path.exists(path):
            return False
        try:
            with open(path) as f:
                state = json.load(f)
            self.cpu.load_state(state["cpu"])
            self.memory.load_state(state["memory"])
            return True
        except (ValueError, KeyError, OSError):
            return False
