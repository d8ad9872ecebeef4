"""Trial bookkeeping (analog of reference python/ray/tune/experiment/
trial.py:282 — one hyperparameter configuration's lifecycle through the
controller)."""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any

_trial_counter = itertools.count()

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


@dataclass
class Trial:
    config: dict
    trial_id: str = ""
    experiment_tag: str = ""
    status: str = PENDING
    last_result: dict = field(default_factory=dict)
    metric_history: list = field(default_factory=list)
    error_msg: str | None = None
    num_failures: int = 0
    checkpoint: Any = None  # latest air.Checkpoint
    start_time: float = 0.0
    # Per-trial resource override (ResourceChangingScheduler); None means
    # the experiment-wide resources_per_trial applies.
    resources: dict | None = None
    # runtime handles (not persisted)
    tracked_actor: Any = None  # air.execution.TrackedActor driving this trial

    def __post_init__(self):
        if not self.trial_id:
            self.trial_id = f"{int(time.time()) % 100000:05d}_{next(_trial_counter):05d}"

    @property
    def iteration(self) -> int:
        return int(self.last_result.get("training_iteration", 0))

    def metric_value(self, metric: str):
        return self.last_result.get(metric)

    def summary(self) -> dict:
        return {
            "trial_id": self.trial_id,
            "config": self.config,
            "status": self.status,
            "last_result": {k: v for k, v in self.last_result.items() if not callable(v)},
            "error_msg": self.error_msg,
            "num_failures": self.num_failures,
        }

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status}, iter={self.iteration})"
