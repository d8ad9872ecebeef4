"""BaseTrainer + Result.

Analog of the reference's BaseTrainer (python/ray/train/base_trainer.py:559
fit-via-Tune): ``fit()`` runs the trainer directly; ``tune.Tuner(trainer)``
runs it as a trial through ``as_trainable``.
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
        """Adapter so tune.Tuner can run this trainer as a trial
        (reference: base_trainer.py as_trainable)."""
        trainer = self

        def _train_fn(config):
            from ray_tpu_torch.tune import report as tune_report

            merged = trainer._with_config_overrides(config)
            result = merged._fit_direct()
            if result.error:
                # A failed fit must fail the trial, not complete it with
                # empty metrics.
                raise RuntimeError(f"trainer fit failed: {result.error}")
            tune_report(result.metrics, checkpoint=result.checkpoint)

        return _train_fn

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
