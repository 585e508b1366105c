"""Consecutive-observation anomaly detector (a copy of
``koordinator_tpu/descheduler/anomaly.py``).

Semantics oracle: pkg/descheduler/framework/plugins/loadaware/anomaly/
(BasicDetector): a node is flagged anomalous only after strictly more
than N consecutive abnormal observations, and returns to normal after
strictly more than M consecutive normal ones (debounce against
utilization flapping, low_node_load.go:258 filterRealAbnormalNodes).
"""

from __future__ import annotations

import enum
import time


class State(enum.Enum):
    OK = "ok"
    ANOMALY = "anomaly"


class BasicDetector:
    def __init__(
        self,
        name: str,
        consecutive_abnormalities: int = 1,
        consecutive_normalities: int = 1,
        timeout: float = 0.0,
        clock=time.monotonic,
    ):
        self.name = name
        self.consecutive_abnormalities = consecutive_abnormalities
        self.consecutive_normalities = consecutive_normalities
        self.timeout = timeout
        self.clock = clock
        self.abnormal_streak = 0
        self.normal_streak = 0
        self.state = State.OK
        self.last_mark = clock()

    def mark(self, normal: bool) -> State:
        now = self.clock()
        if self.timeout and now - self.last_mark > self.timeout:
            self.reset()
        self.last_mark = now
        if normal:
            self.normal_streak += 1
            self.abnormal_streak = 0
            if (
                self.state == State.ANOMALY
                and self.normal_streak > self.consecutive_normalities
            ):
                self.state = State.OK
        else:
            self.abnormal_streak += 1
            self.normal_streak = 0
            if self.abnormal_streak > self.consecutive_abnormalities:
                self.state = State.ANOMALY
        return self.state

    def reset(self) -> None:
        self.abnormal_streak = 0
        self.normal_streak = 0
        self.state = State.OK
