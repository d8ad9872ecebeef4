"""TrialScheduler protocol (analog of reference python/ray/tune/schedulers/
trial_scheduler.py — decisions on each result: CONTINUE / PAUSE / STOP)."""

from __future__ import annotations

CONTINUE = "CONTINUE"
PAUSE = "PAUSE"
STOP = "STOP"


class TrialScheduler:
    def set_search_properties(self, metric: str | None, mode: str | None) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    metric: str | None = None
    mode: str = "max"

    def on_trial_add(self, controller, trial) -> None:
        pass

    def on_trial_result(self, controller, trial, result: dict) -> str:
        return CONTINUE

    def on_trial_complete(self, controller, trial, result: dict) -> None:
        pass

    def on_trial_error(self, controller, trial) -> None:
        pass

    def choose_trial_to_run(self, controller):
        """Pick the next PENDING/PAUSED trial to (re)start, or None."""
        from ray_tpu_torch.tune.experiment.trial import PAUSED, PENDING

        for t in controller.trials:
            if t.status == PENDING:
                return t
        for t in controller.trials:
            if t.status == PAUSED:
                return t
        return None

    def on_no_available_trials(self, controller) -> None:
        """Called when the experiment would otherwise deadlock: nothing is
        running and choose_trial_to_run returned None while gated trials
        remain. Schedulers holding synchronization state (e.g. sync
        HyperBand rungs) release their gates consistently here — the
        controller re-asks choose_trial_to_run afterwards instead of
        force-starting a gated trial past its milestone."""


class FIFOScheduler(TrialScheduler):
    pass
