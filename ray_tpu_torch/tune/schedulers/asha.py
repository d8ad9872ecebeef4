"""Asynchronous Successive Halving (analog of reference
python/ray/tune/schedulers/async_hyperband.py ASHAScheduler).

Rungs at reduction_factor^k * grace_period; a trial reaching a rung is stopped
unless its metric is in the top 1/reduction_factor of recorded values at that
rung. Fully asynchronous: decisions use whatever has been recorded so far.
"""

from __future__ import annotations

import math

from ray_tpu_torch.tune.schedulers.trial_scheduler import CONTINUE, STOP, TrialScheduler


class _Bracket:
    def __init__(self, min_t: int, max_t: int, rf: float, stop_last: bool):
        self.rf = rf
        self.rungs: list[tuple[int, dict]] = []  # (milestone, {trial_id: metric})
        t = max_t
        while t > min_t:
            self.rungs.append((t, {}))
            t = int(t / rf)
        self.rungs.append((min_t, {}))
        self.rungs = sorted(self.rungs)  # ascending milestones
        self.stop_last = stop_last

    def on_result(self, trial_id: str, cur_iter: int, metric: float) -> str:
        decision = CONTINUE
        for milestone, recorded in self.rungs:
            if cur_iter < milestone or trial_id in recorded:
                continue
            recorded[trial_id] = metric
            values = sorted(recorded.values())
            if len(values) >= self.rf:
                cutoff_idx = int(math.ceil(len(values) * (1 - 1 / self.rf))) - 1
                cutoff = values[max(cutoff_idx, 0)]
                if metric < cutoff:
                    decision = STOP
            break
        return decision


class ASHAScheduler(TrialScheduler):
    def __init__(
        self,
        metric: str | None = None,
        mode: str = "max",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: float = 4,
        time_attr: str = "training_iteration",
    ):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        self._bracket = _Bracket(grace_period, max_t, reduction_factor, True)

    def on_trial_result(self, controller, trial, result):
        if self.metric is None or self.metric not in result:
            return CONTINUE
        cur = result.get(self.time_attr, 0)
        if cur >= self.max_t:
            return STOP
        v = float(result[self.metric])
        if self.mode == "min":
            v = -v
        return self._bracket.on_result(trial.trial_id, int(cur), v)
