"""TuneController (analog of reference python/ray/tune/execution/
tune_controller.py:49): the experiment step loop.

Each trial runs in a dedicated **trial actor** (`_TrialActor`) holding one
Trainable. Actor lifecycle — acquisition of the trial's resources, creation,
process-death detection, tracked restarts, release — goes through the shared
AIR execution layer (`ray_tpu_torch.air.execution.ActorManager`, the reference's
RayActorManager shape): the controller schedules `train`/`save` tasks with
callbacks and reacts to results with the searcher + scheduler. Failed trials
(application errors AND actor death) are retried up to ``max_failures`` by
recreating the actor from the latest checkpoint through the manager — the
same restart semantics Train's BackendExecutor gets from the same component.
"""

from __future__ import annotations

import json
import os
import time

import ray_tpu_torch
from ray_tpu_torch.air.execution import (
    ActorManager,
    FixedResourceManager,
    PlacementGroupResourceManager,
    ResourceRequest,
)
from ray_tpu_torch.tune.experiment.trial import (
    ERROR,
    PAUSED,
    PENDING,
    RUNNING,
    TERMINATED,
    Trial,
)
from ray_tpu_torch.tune.schedulers.pbt import EXPLOIT, PopulationBasedTraining
from ray_tpu_torch.tune.schedulers.trial_scheduler import (
    CONTINUE,
    PAUSE,
    STOP,
    FIFOScheduler,
    TrialScheduler,
)
from ray_tpu_torch.tune.search.searcher import Searcher
from ray_tpu_torch.tune.trainable import RESULT_DONE, Trainable, wrap_function


class _TrialActor:
    """Actor hosting one Trainable instance (reference: the trainable-as-actor
    pattern, ray_trial_executor.py:382 _setup_remote_runner)."""

    def __init__(self, trainable_cls, config: dict, checkpoint=None, trial_resources: dict | None = None):
        self._trainable: Trainable = trainable_cls(config)
        # Current trial resources (reference: Trainable.trial_resources) —
        # updated on every (re)start so ResourceChangingScheduler resizes
        # are visible to the training code.
        self._trainable._trial_resources = dict(trial_resources or {})
        if checkpoint is not None:
            self._trainable.restore(checkpoint)

    def train(self) -> dict:
        return self._trainable.train()

    def save(self):
        return self._trainable.save()

    def restore(self, checkpoint) -> None:
        self._trainable.restore(checkpoint)

    def reset(self, new_config: dict, checkpoint=None) -> bool:
        ok = self._trainable.reset_config(new_config)
        if ok and checkpoint is not None:
            self._trainable.restore(checkpoint)
        return ok

    def stop(self) -> None:
        self._trainable.stop()


class TuneController:
    def __init__(
        self,
        trainable,
        *,
        param_space: dict | None = None,
        searcher: Searcher,
        scheduler: TrialScheduler | None = None,
        metric: str | None = None,
        mode: str = "max",
        num_samples: int = 1,
        max_concurrent: int | None = None,
        stop: dict | None = None,
        time_budget_s: float | None = None,
        max_failures: int = 0,
        resources_per_trial: dict | None = None,
        experiment_dir: str | None = None,
        experiment_name: str = "exp",
        checkpoint_frequency: int = 1,
        sync_config=None,
        resource_manager=None,
    ):
        if isinstance(trainable, type) and issubclass(trainable, Trainable):
            self.trainable_cls = trainable
        elif callable(trainable):
            self.trainable_cls = wrap_function(trainable)
        else:
            raise TypeError(f"trainable must be a Trainable subclass or function, got {trainable!r}")
        self.searcher = searcher
        self.scheduler = scheduler or FIFOScheduler()
        self.metric = metric
        self.mode = mode
        self.num_samples = num_samples
        self.max_concurrent = max_concurrent
        self.stop_criteria = stop or {}
        self.time_budget_s = time_budget_s
        self.max_failures = max_failures
        self.resources_per_trial = resources_per_trial or {"CPU": 1}
        self.experiment_dir = experiment_dir
        self.experiment_name = experiment_name
        self.checkpoint_frequency = checkpoint_frequency
        self._sync_manager = None
        if sync_config is not None and experiment_dir:
            from ray_tpu_torch.tune.syncer import SyncManager

            self._sync_manager = SyncManager(sync_config, experiment_dir, experiment_name)
        self._logger_manager = None
        if experiment_dir:
            from ray_tpu_torch.tune.logger import LoggerManager

            self._logger_manager = LoggerManager(experiment_dir)

        # The shared AIR execution substrate. GPU trials reserve their share
        # of the card through placement groups; plain CPU trials use budget
        # bookkeeping with raylet enforcement.
        if resource_manager is None:
            resource_manager = (
                PlacementGroupResourceManager()
                if "GPU" in self.resources_per_trial
                else FixedResourceManager()
            )
        self._actor_manager = ActorManager(resource_manager)

        self.trials: list[Trial] = []
        self._searcher_done = False
        self._start_time = time.time()
        self._saved_ckpt_ids: dict[str, int] = {}

        self.searcher.set_search_properties(metric, mode, param_space or {})
        self.scheduler.set_search_properties(metric, mode)

    # -- trial lifecycle ----------------------------------------------------

    def _trial_resources(self, trial: Trial) -> dict:
        # Per-trial override (ResourceChangingScheduler) wins over the
        # experiment-wide default.
        return dict(
            trial.resources
            if trial.resources
            else self.resources_per_trial
        )

    def _start_trial(self, trial: Trial, checkpoint=None, config: dict | None = None):
        if config is not None:
            trial.config = config
        if checkpoint is not None:
            trial.checkpoint = checkpoint
        res = self._trial_resources(trial)

        def _constructor_kwargs():
            # Re-resolved on every (re)start by the manager, so a restart
            # after a failure picks up the LATEST checkpoint and config.
            return dict(
                trainable_cls=self.trainable_cls,
                config=trial.config,
                checkpoint=trial.checkpoint,
                trial_resources=self._trial_resources(trial),
            )

        trial.tracked_actor = self._actor_manager.add_actor(
            _TrialActor,
            kwargs_fn=_constructor_kwargs,
            resource_request=ResourceRequest([res]),
            on_start=self._make_on_start(trial),
            on_failure=self._make_on_failure(trial),
            # Process-death restarts share the trial's failure budget; the
            # manager recreates from the latest checkpoint via kwargs_fn.
            max_restarts=(-1 if self.max_failures < 0 else self.max_failures),
            restart_backoff_s=0.5,
            graceful_stop_method="stop",
        )
        trial.status = RUNNING

    def _stop_trial(self, trial: Trial, status: str = TERMINATED):
        if trial.tracked_actor is not None:
            self._actor_manager.remove_actor(trial.tracked_actor)
            trial.tracked_actor = None
        trial.status = status

    # -- manager callbacks --------------------------------------------------

    def _make_on_start(self, trial: Trial):
        def on_start(tracked):
            if trial.tracked_actor is not tracked:
                return  # stale callback from a replaced actor
            trial.start_time = time.time()
            self._schedule_train(trial)

        return on_start

    def _make_on_failure(self, trial: Trial):
        def on_failure(tracked, error, will_restart):
            if trial.tracked_actor is not tracked:
                return
            trial.num_failures += 1
            trial.error_msg = f"{type(error).__name__}: {error}"
            if will_restart:
                # The manager recreates the actor from the latest checkpoint
                # (kwargs_fn); on_start reschedules training.
                return
            self._fail_trial(trial)

        return on_failure

    def _fail_trial(self, trial: Trial):
        """Terminal failure (budget exhausted): same bookkeeping whether the
        last straw was a process death or an application exception."""
        self.searcher.on_trial_complete(trial.trial_id, error=True)
        self.scheduler.on_trial_error(self, trial)
        self._stop_trial(trial, ERROR)

    def _schedule_train(self, trial: Trial):
        tracked = trial.tracked_actor
        self._actor_manager.schedule_actor_task(
            tracked,
            "train",
            on_result=lambda value: self._on_result(trial, tracked, value),
            on_error=lambda err: self._on_app_error(trial, tracked, err),
        )

    def _save_then(self, trial: Trial, next_action: str):
        tracked = trial.tracked_actor
        self._actor_manager.schedule_actor_task(
            tracked,
            "save",
            on_result=lambda value: self._on_saved(trial, tracked, value, next_action),
            on_error=lambda err: self._on_app_error(trial, tracked, err),
        )

    def _on_saved(self, trial: Trial, tracked, value, next_action: str):
        if trial.tracked_actor is not tracked:
            return
        if value is not None:
            trial.checkpoint = value
        if next_action == "train":
            self._schedule_train(trial)
        else:  # pause
            self._stop_trial(trial, PAUSED)

    def _on_app_error(self, trial: Trial, tracked, err: Exception):
        """The trainable raised (the actor process is still alive). Shares
        the trial failure budget with process-death restarts: retry from the
        latest checkpoint through the manager, else surface the error."""
        if trial.tracked_actor is not tracked:
            return
        trial.num_failures += 1
        trial.error_msg = f"{type(err).__name__}: {err}"
        if trial.num_failures <= self.max_failures or self.max_failures < 0:
            # Manager-driven recreate: kwargs_fn re-resolves to the latest
            # checkpoint; on_start fires again and reschedules training.
            self._actor_manager.restart_actor(tracked)
        else:
            self._fail_trial(trial)

    def _maybe_add_trial(self) -> bool:
        """Ask the searcher for a new config; returns True if a trial was added."""
        if self._searcher_done:
            return False
        total = self.searcher.total_samples
        if total is not None and len(self.trials) >= total:
            self._searcher_done = True
            return False
        if total is None and len(self.trials) >= self.num_samples:
            self._searcher_done = True
            return False
        trial = Trial(config={})
        cfg = self.searcher.suggest(trial.trial_id)
        if cfg is None:
            return False  # limiter saturated or exhausted; retry later
        trial.config = cfg
        self.trials.append(trial)
        self.scheduler.on_trial_add(self, trial)
        return True

    def _live_trials(self) -> list[Trial]:
        return [t for t in self.trials if t.status == RUNNING]

    def _should_stop_trial(self, result: dict) -> bool:
        if result.get(RESULT_DONE):
            return True
        # Stop criteria are always "stop once value reaches bound", regardless
        # of optimisation mode (reference Ray semantics).
        for key, bound in self.stop_criteria.items():
            v = result.get(key)
            if v is not None and v >= bound:
                return True
        return False

    # -- result handling ----------------------------------------------------

    def _on_result(self, trial: Trial, tracked, result: dict):
        if trial.tracked_actor is not tracked:
            return  # stale callback from a replaced actor
        # A bare done sentinel (function trainable ending) carries no new
        # metrics — logging it would duplicate the last row. Trainable.train
        # decorates every result with iteration/timing bookkeeping, so only
        # non-bookkeeping keys count; a final step reporting real metrics
        # together with done is still logged.
        raw_has_metrics = any(
            k not in (RESULT_DONE, "training_iteration", "time_total_s", "time_this_iter_s")
            for k in result
        )
        # merge so the final done-sentinel step doesn't erase reported metrics
        trial.last_result = {**trial.last_result, **result}
        result = trial.last_result
        if self.metric and self.metric in result:
            trial.metric_history.append(result[self.metric])
        if self._logger_manager is not None and raw_has_metrics:
            self._logger_manager.on_result(trial, result)
        self.searcher.on_trial_result(trial.trial_id, result)

        if self._should_stop_trial(result):
            self._complete_trial(trial, result)
            return

        decision = self.scheduler.on_trial_result(self, trial, result)
        if decision == STOP:
            self._complete_trial(trial, result)
        elif decision == PAUSE:
            self._save_then(trial, next_action="pause")
        elif decision == EXPLOIT:
            donor, new_config = self.scheduler.pending_exploit.pop(trial.trial_id)
            self._exploit(trial, donor, new_config)
        else:  # CONTINUE
            if self.checkpoint_frequency and trial.iteration % self.checkpoint_frequency == 0:
                self._save_then(trial, next_action="train")
            else:
                self._schedule_train(trial)

    def _complete_trial(self, trial: Trial, result: dict):
        self.searcher.on_trial_complete(trial.trial_id, result)
        self.scheduler.on_trial_complete(self, trial, result)
        # capture a final checkpoint before teardown
        tracked = trial.tracked_actor
        if tracked is not None and tracked.actor_handle is not None:
            try:
                ckpt = ray_tpu_torch.get(tracked.actor_handle.save.remote(), timeout=30)
                if ckpt is not None:
                    trial.checkpoint = ckpt
            except Exception:
                pass
        self._stop_trial(trial, TERMINATED)

    def stop_trial(self, trial: Trial):
        """Scheduler-initiated termination of a trial other than the one
        being processed (e.g. HyperBand halving losers). The scheduler has
        already accounted for it — only the searcher needs the completion."""
        if trial.status in (RUNNING, PENDING, PAUSED):
            self.searcher.on_trial_complete(trial.trial_id, trial.last_result)
            self._stop_trial(trial, TERMINATED)

    def _exploit(self, trial: Trial, donor: Trial, new_config: dict):
        """PBT: restart `trial` from donor's checkpoint with a mutated config."""
        self._stop_trial(trial, PENDING)
        self._start_trial(trial, checkpoint=donor.checkpoint, config=new_config)

    # -- main loop ----------------------------------------------------------

    def step(self):
        """One controller iteration: top up trials, drive the actor manager
        (starts, task results, failures), react via callbacks."""
        cap = self.max_concurrent or max(1, int(ray_tpu_torch.cluster_resources().get("CPU", 1)))
        while len(self._live_trials()) < cap:
            pending = [t for t in self.trials if t.status in (PENDING, PAUSED)]
            if pending:
                t = self.scheduler.choose_trial_to_run(self)
                if t is None:
                    # Scheduler is gating the paused trials (e.g. sync
                    # HyperBand mid-rung). Try topping up with a fresh trial;
                    # otherwise respect the gate while work is running. With
                    # nothing running, ask the scheduler to release its gates
                    # consistently (finalize/halve incomplete rungs) and
                    # re-ask. As an absolute last resort prefer forcing a
                    # PENDING trial (safe); if only gated PAUSED trials
                    # remain, one IS forced past its milestone — a scheduler
                    # that must never allow that has to release the gate in
                    # its on_no_available_trials hook (livelock is worse
                    # than an invariant break we can't see from here).
                    if self._maybe_add_trial():
                        continue
                    if self._live_trials():
                        break
                    self.scheduler.on_no_available_trials(self)
                    t = self.scheduler.choose_trial_to_run(self)
                    if t is None:
                        pending = [x for x in self.trials if x.status in (PENDING, PAUSED)]
                        if not pending:
                            break
                        t = next((x for x in pending if x.status == PENDING), pending[0])
                self._start_trial(t)
                continue
            if not self._maybe_add_trial():
                break

        if not self._live_trials():
            return
        self._actor_manager.next(timeout=10.0)

    def is_finished(self) -> bool:
        if self.time_budget_s and time.time() - self._start_time > self.time_budget_s:
            return True
        active = [t for t in self.trials if t.status in (RUNNING, PENDING, PAUSED)]
        return self._searcher_done and not active

    def run(self):
        try:
            while not self.is_finished():
                self.step()
                self.save_experiment_state()
                if self._sync_manager is not None:
                    self._sync_manager.maybe_sync_up()
        finally:
            for t in self._live_trials():
                self._stop_trial(t, TERMINATED)
            # Guaranteed release: whatever the exit path, no trial actor nor
            # resource acquisition survives the controller.
            self._actor_manager.clear()
            self.save_experiment_state()
            if self._logger_manager is not None:
                self._logger_manager.close()
            if self._sync_manager is not None:
                self._sync_manager.maybe_sync_up(force=True)
        return self.trials

    # -- persistence (reference: execution/experiment_state.py) -------------

    def save_experiment_state(self):
        if not self.experiment_dir:
            return
        os.makedirs(self.experiment_dir, exist_ok=True)
        state = {
            "experiment_name": self.experiment_name,
            "metric": self.metric,
            "mode": self.mode,
            "trials": [t.summary() for t in self.trials],
            "timestamp": time.time(),
        }
        path = os.path.join(self.experiment_dir, "experiment_state.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1, default=str)
        os.replace(tmp, path)
        for t in self.trials:
            # only re-serialise checkpoints that changed since the last save
            if t.checkpoint is not None and self._saved_ckpt_ids.get(t.trial_id) != id(t.checkpoint):
                try:
                    t.checkpoint.to_directory(
                        os.path.join(self.experiment_dir, f"checkpoint_{t.trial_id}")
                    )
                    self._saved_ckpt_ids[t.trial_id] = id(t.checkpoint)
                except Exception:
                    pass

    @staticmethod
    def load_experiment_state(experiment_dir: str) -> dict:
        # Shared loader: Tuner.restore and offline ExperimentAnalysis read
        # the experiment directory through the same schema/parser.
        from ray_tpu_torch.tune.analysis import ExperimentAnalysis

        ea = ExperimentAnalysis(experiment_dir)
        state = ea._state
        for ts, rec in zip(state["trials"], ea.trials):
            ckpt = rec.checkpoint
            if ckpt is not None:
                ts["checkpoint"] = ckpt
        return state
