"""ResourceChangingScheduler — resize trials mid-run.

Analog of the reference's resource_changing_scheduler.py:590: wraps a base
scheduler; after each result a ``resources_allocation_function`` may
propose a new resource dict for the trial. A change pauses the trial
(checkpoint via the controller's normal PAUSE path), stores the new
resources on the Trial, and the restart re-places the actor with them —
the Trainable sees the update through ``self.trial_resources``.
"""

from __future__ import annotations

from typing import Callable, Optional

from ray_tpu_torch.tune.schedulers.trial_scheduler import CONTINUE, PAUSE, FIFOScheduler, TrialScheduler


class DistributeResources:
    """Default allocation policy (reference: DistributeResources): split
    the cluster's CPUs evenly among unfinished trials, each trial at least
    its original request."""

    def __call__(self, controller, trial, result, scheduler) -> Optional[dict]:
        import ray_tpu_torch
        from ray_tpu_torch.tune.experiment.trial import PAUSED, PENDING, RUNNING

        try:
            total = int(ray_tpu_torch.cluster_resources().get("CPU", 1))
        except Exception:
            return None
        live = [t for t in controller.trials if t.status in (RUNNING, PENDING, PAUSED)]
        if not live:
            return None
        base = int(controller.resources_per_trial.get("CPU", 1))
        share = max(base, total // len(live))
        current = dict(trial.resources or controller.resources_per_trial)
        if int(current.get("CPU", 1)) == share:
            return None
        current["CPU"] = share
        return current


class ResourceChangingScheduler(TrialScheduler):
    def __init__(self, base_scheduler: Optional[TrialScheduler] = None,
                 resources_allocation_function: Optional[Callable] = None):
        self.base = base_scheduler or FIFOScheduler()
        self.fn = resources_allocation_function or DistributeResources()
        self.reallocated: dict[str, int] = {}  # trial_id -> resize count

    def set_search_properties(self, metric, mode) -> bool:
        super().set_search_properties(metric, mode)
        return self.base.set_search_properties(metric, mode)

    def on_trial_add(self, controller, trial) -> None:
        self.base.on_trial_add(controller, trial)

    def on_trial_result(self, controller, trial, result: dict) -> str:
        decision = self.base.on_trial_result(controller, trial, result)
        if decision != CONTINUE:
            return decision
        new = self.fn(controller, trial, result, self)
        old = dict(trial.resources or controller.resources_per_trial)
        if new and dict(new) != old:
            trial.resources = dict(new)
            self.reallocated[trial.trial_id] = self.reallocated.get(trial.trial_id, 0) + 1
            if trial.iteration > 0 and trial.checkpoint is None:
                # The PAUSE below checkpoints via Trainable.save(); a
                # trainable without save_checkpoint yields None and the
                # restart begins from iteration 0 — resize still happens,
                # but pre-resize progress is redone. Say so loudly.
                import logging

                logging.getLogger(__name__).warning(
                    "ResourceChangingScheduler: trial %s has no checkpoint; "
                    "resizing restarts it from iteration 0 (implement "
                    "save_checkpoint to carry progress across resizes)",
                    trial.trial_id,
                )
            # PAUSE drives the controller's checkpoint-then-stop path; the
            # restart re-places the actor under the new resources.
            return PAUSE
        return decision

    def on_trial_complete(self, controller, trial, result: dict) -> None:
        self.base.on_trial_complete(controller, trial, result)

    def on_trial_error(self, controller, trial) -> None:
        self.base.on_trial_error(controller, trial)

    def choose_trial_to_run(self, controller):
        return self.base.choose_trial_to_run(controller)

    def on_no_available_trials(self, controller) -> None:
        self.base.on_no_available_trials(controller)
