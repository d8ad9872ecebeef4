"""Synchronous HyperBand (analog of reference python/ray/tune/schedulers/
hyperband.py HyperBandScheduler).

Trials fill brackets; each bracket runs successive-halving rounds: all member
trials run to the current milestone (PAUSE as they arrive), then the top
1/eta continue into the next rung and the rest STOP. Unlike ASHA (async,
never pauses), a rung only halves when every live member has reported — the
synchronous algorithm of Li et al. 2016.
"""

from __future__ import annotations

import math

from ray_tpu_torch.tune.experiment.trial import PAUSED, PENDING, RUNNING
from ray_tpu_torch.tune.schedulers.trial_scheduler import (
    CONTINUE,
    PAUSE,
    STOP,
    TrialScheduler,
)


class _SyncBracket:
    def __init__(self, n0: int, r0: int, eta: float, max_t: int):
        self.eta = eta
        self.max_t = max_t
        self.capacity = n0
        self.trials: list = []
        self.milestone = min(r0, max_t)
        self.cum_iter = self.milestone
        self.results: dict[str, float] = {}  # trial_id -> metric at milestone
        self.dropped: set[str] = set()

    @property
    def full(self) -> bool:
        return len(self.trials) >= self.capacity

    def add(self, trial):
        self.trials.append(trial)

    def live(self) -> list:
        return [t for t in self.trials if t.trial_id not in self.dropped]

    def on_result(self, trial, cur_iter: int, metric: float) -> str:
        if cur_iter < self.milestone or trial.trial_id in self.results:
            return CONTINUE
        self.results[trial.trial_id] = metric
        if self.milestone >= self.max_t:
            return STOP  # ran the full budget
        return PAUSE

    def try_halve(self) -> tuple[list, list]:
        """If every live member has reported at the milestone, keep the top
        1/eta; returns (promoted_trials, stopped_trials), or ([], []) if the
        rung isn't complete yet."""
        live = self.live()
        if not live or any(t.trial_id not in self.results for t in live):
            return [], []
        ranked = sorted(live, key=lambda t: self.results[t.trial_id], reverse=True)
        keep = max(1, int(len(ranked) / self.eta))
        promoted, stopped = ranked[:keep], ranked[keep:]
        for t in stopped:
            self.dropped.add(t.trial_id)
        self.milestone = min(int(self.milestone * self.eta), self.max_t)
        self.results = {}
        return promoted, stopped


class HyperBandScheduler(TrialScheduler):
    def __init__(
        self,
        metric: str | None = None,
        mode: str = "max",
        max_t: int = 81,
        reduction_factor: float = 3,
        time_attr: str = "training_iteration",
    ):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.eta = reduction_factor
        self.time_attr = time_attr
        self._brackets: list[_SyncBracket] = []
        self._trial_bracket: dict[str, _SyncBracket] = {}
        # Bracket shapes cycle s = s_max..0 (reference: HyperBandScheduler
        # uses the same (n, r) schedule from the paper).
        self._s_max = int(math.log(max_t, self.eta))
        self._next_s = self._s_max

    def _new_bracket(self) -> _SyncBracket:
        s = self._next_s
        self._next_s = self._next_s - 1 if self._next_s > 0 else self._s_max
        n0 = int(math.ceil((self._s_max + 1) * self.eta**s / (s + 1)))
        r0 = max(1, int(self.max_t * self.eta**-s))
        b = _SyncBracket(n0, r0, self.eta, self.max_t)
        self._brackets.append(b)
        return b

    def on_trial_add(self, controller, trial):
        b = next((x for x in self._brackets if not x.full), None) or self._new_bracket()
        b.add(trial)
        self._trial_bracket[trial.trial_id] = b

    def _signed(self, result: dict) -> float | None:
        v = result.get(self.metric) if self.metric else None
        if v is None:
            return None
        return float(v) if self.mode == "max" else -float(v)

    def on_trial_result(self, controller, trial, result):
        b = self._trial_bracket.get(trial.trial_id)
        metric = self._signed(result)
        if b is None or metric is None:
            return CONTINUE
        decision = b.on_result(trial, int(result.get(self.time_attr, 0)), metric)
        if decision == PAUSE:
            # A pause may complete the rung: losers stop, winners resume via
            # choose_trial_to_run picking PAUSED trials.
            _, stopped = b.try_halve()
            for t in stopped:
                if t.trial_id == trial.trial_id:
                    decision = STOP
                elif t.status in (RUNNING, PAUSED, PENDING):
                    controller.stop_trial(t)
        return decision

    def on_trial_complete(self, controller, trial, result):
        b = self._trial_bracket.get(trial.trial_id)
        if b is not None:
            b.dropped.add(trial.trial_id)
            _, stopped = b.try_halve()
            for t in stopped:
                controller.stop_trial(t)

    def on_trial_error(self, controller, trial):
        self.on_trial_complete(controller, trial, {})

    def on_no_available_trials(self, controller):
        """Deadlock release: members that can no longer report (terminated
        outside the bracket's bookkeeping) must not hold a rung open — drop
        them and finalize the halving so PAUSED winners become resumable."""
        for b in self._brackets:
            for t in b.live():
                if t.status not in (RUNNING, PAUSED, PENDING):
                    b.dropped.add(t.trial_id)
            _, stopped = b.try_halve()
            for t in stopped:
                controller.stop_trial(t)

    def choose_trial_to_run(self, controller):
        """PENDING trials fill brackets; a PAUSED trial is resumable ONLY
        after its rung halved (its id left bracket.results) — resuming
        earlier would run it past the milestone while rung-mates are still
        below it, breaking the synchronous halving invariant."""
        from ray_tpu_torch.tune.experiment.trial import PAUSED, PENDING

        for t in controller.trials:
            if t.status == PENDING:
                return t
        for t in controller.trials:
            if t.status != PAUSED:
                continue
            b = self._trial_bracket.get(t.trial_id)
            if b is None:
                return t
            if t.trial_id not in b.dropped and t.trial_id not in b.results:
                return t
        return None
