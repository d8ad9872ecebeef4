"""Median stopping rule (analog of reference python/ray/tune/schedulers/
median_stopping_rule.py): stop a trial whose best result so far is worse than
the median of other trials' running averages at the same point in time."""

from __future__ import annotations

import statistics

from ray_tpu_torch.tune.schedulers.trial_scheduler import CONTINUE, STOP, TrialScheduler


class MedianStoppingRule(TrialScheduler):
    def __init__(
        self,
        metric: str | None = None,
        mode: str = "max",
        grace_period: int = 1,
        min_samples_required: int = 3,
        time_attr: str = "training_iteration",
    ):
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self.time_attr = time_attr
        self._histories: dict[str, list[float]] = {}

    def _signed(self, v: float) -> float:
        return float(v) if self.mode == "max" else -float(v)

    def on_trial_result(self, controller, trial, result):
        if self.metric is None or self.metric not in result:
            return CONTINUE
        hist = self._histories.setdefault(trial.trial_id, [])
        hist.append(self._signed(result[self.metric]))
        t = int(result.get(self.time_attr, 0))
        if t < self.grace_period:
            return CONTINUE
        other_avgs = [
            statistics.fmean(h[:t] or h)
            for tid, h in self._histories.items()
            if tid != trial.trial_id and h
        ]
        if len(other_avgs) < self.min_samples:
            return CONTINUE
        if max(hist) < statistics.median(other_avgs):
            return STOP
        return CONTINUE
