"""BaseTrainer + Result.

Analog of the reference's BaseTrainer (python/ray/train/base_trainer.py:559
fit-via-Tune): ``fit()`` runs the trainer directly; the 1-trial Tune path
waits for Tune (ROADMAP A5, what remains).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig


@dataclass
class Result:
    metrics: dict = field(default_factory=dict)
    checkpoint: Checkpoint | None = None
    error: str | None = None
    path: str | None = None
    metrics_dataframe: object | None = None
    config: dict = field(default_factory=dict)  # the trial's resolved config


class BaseTrainer:
    def __init__(
        self,
        *,
        scaling_config: ScalingConfig | None = None,
        run_config: RunConfig | None = None,
        resume_from_checkpoint: Checkpoint | None = None,
        datasets: dict | None = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.resume_from_checkpoint = resume_from_checkpoint
        self.datasets = datasets or {}

    def _run_dir(self) -> str:
        return self.run_config.resolve_dir(type(self).__name__)

    def training_loop(self) -> None:
        raise NotImplementedError

    def fit(self) -> Result:
        """Run to completion (reference routes this through a 1-trial Tune
        experiment — tune.Tuner(trainer).fit() does the same here)."""
        return self._fit_direct()

    def _fit_direct(self) -> Result:
        raise NotImplementedError

    def as_trainable(self):
        """Tune is not ported (ROADMAP A5, what remains)."""
        raise NotImplementedError("Tune is not ported (ROADMAP A5, what remains)")

    def _with_config_overrides(self, config: dict) -> "BaseTrainer":
        if not config:
            return self
        import copy

        clone = copy.copy(self)
        overrides = config.get("train_loop_config")
        if overrides is not None and hasattr(clone, "train_loop_config"):
            merged = dict(getattr(clone, "train_loop_config") or {})
            merged.update(overrides)
            clone.train_loop_config = merged
        return clone
