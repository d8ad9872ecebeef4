"""Tuner (analog of reference python/ray/tune/tuner.py:53, .fit:320) and
tune.run (tune/tune.py:293).

``Tuner(trainable, param_space=..., tune_config=..., run_config=...).fit()``
drives a TuneController experiment and returns a ResultGrid. Accepts a
BaseTrainer too (reference base_trainer.py:559 fit-via-Tune): its
ScalingConfig becomes the trial resource request and its ``as_trainable``
adapter the trial body.
"""

from __future__ import annotations

import os
import time

from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.train.base_trainer import BaseTrainer, Result
from ray_tpu_torch.tune.execution.tune_controller import TuneController
from ray_tpu_torch.tune.experiment.trial import ERROR
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator
from ray_tpu_torch.tune.tune_config import TuneConfig


def _experiment_dir(run_config: RunConfig, default_name: str) -> str:
    return run_config.resolve_dir(default_name)


class Tuner:
    def __init__(
        self,
        trainable=None,
        *,
        param_space: dict | None = None,
        tune_config: TuneConfig | None = None,
        run_config: RunConfig | None = None,
        _restore_dir: str | None = None,
    ):
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self._restore_dir = _restore_dir
        self._restore_state: dict | None = None

        if isinstance(trainable, BaseTrainer):
            self._trainer = trainable
            self.trainable = trainable.as_trainable()
            self.run_config = run_config or trainable.run_config
            res = trainable.scaling_config.worker_resources()
            # trial actor itself is light; workers carry the card
            self._resources_per_trial = {"CPU": 1} if res.get("GPU") else dict(res)
        else:
            self._trainer = None
            self.trainable = trainable
            self.run_config = run_config or RunConfig()
            self._resources_per_trial = {"CPU": 1}

    @classmethod
    def restore(cls, path: str, trainable, *, param_space: dict | None = None,
                tune_config: TuneConfig | None = None, run_config: RunConfig | None = None):
        """Resume an interrupted experiment from its directory (reference
        Tuner.restore): TERMINATED trials are kept as results; RUNNING/PENDING/
        ERROR trials are re-run from their last checkpoint."""
        run_config = run_config or RunConfig()
        run_config.storage_path = os.path.dirname(path)
        run_config.name = os.path.basename(path)
        t = cls(trainable, param_space=param_space, tune_config=tune_config,
                run_config=run_config, _restore_dir=path)
        t._restore_state = TuneController.load_experiment_state(path)
        return t

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        searcher = tc.search_alg or BasicVariantGenerator(
            self.param_space, num_samples=tc.num_samples
        )
        exp_dir = self._restore_dir or _experiment_dir(
            self.run_config, getattr(self.trainable, "__name__", "exp")
        )
        controller = TuneController(
            self.trainable,
            param_space=self.param_space,
            searcher=searcher,
            scheduler=tc.scheduler,
            metric=tc.metric,
            mode=tc.mode,
            num_samples=tc.num_samples,
            max_concurrent=tc.max_concurrent_trials,
            stop=self.run_config.stop,
            time_budget_s=tc.time_budget_s,
            max_failures=self.run_config.failure_config.max_failures,
            resources_per_trial=self._resources_per_trial,
            experiment_dir=exp_dir,
            experiment_name=self.run_config.name or "exp",
            sync_config=self.run_config.sync_config,
        )
        if self._restore_state is not None:
            self._seed_from_restore(controller)
        trials = controller.run()
        results = [
            Result(
                metrics=t.last_result,
                checkpoint=t.checkpoint,
                error=t.error_msg if t.status == ERROR else None,
                path=exp_dir,
                config=dict(t.config),
            )
            for t in trials
        ]
        return ResultGrid(results, trials, default_metric=tc.metric, default_mode=tc.mode)

    def _seed_from_restore(self, controller: TuneController):
        from ray_tpu_torch.tune.experiment.trial import PENDING, TERMINATED, Trial

        for ts in self._restore_state.get("trials", []):
            trial = Trial(
                config=ts["config"],
                trial_id=ts["trial_id"],
                status=TERMINATED if ts["status"] == TERMINATED else PENDING,
                last_result=ts.get("last_result") or {},
                num_failures=0,
                checkpoint=ts.get("checkpoint"),
            )
            controller.trials.append(trial)
        controller._searcher_done = True  # finish restored population only


def run(
    trainable,
    *,
    config: dict | None = None,
    metric: str | None = None,
    mode: str = "max",
    num_samples: int = 1,
    stop: dict | None = None,
    search_alg=None,
    scheduler=None,
    max_concurrent_trials: int | None = None,
    time_budget_s: float | None = None,
    storage_path: str | None = None,
    name: str | None = None,
    resources_per_trial: dict | None = None,
    max_failures: int = 0,
) -> ResultGrid:
    """Functional entrypoint (reference tune.run, tune/tune.py:293)."""
    from ray_tpu_torch.air.config import FailureConfig

    tuner = Tuner(
        trainable,
        param_space=config,
        tune_config=TuneConfig(
            metric=metric,
            mode=mode,
            num_samples=num_samples,
            search_alg=search_alg,
            scheduler=scheduler,
            max_concurrent_trials=max_concurrent_trials,
            time_budget_s=time_budget_s,
        ),
        run_config=RunConfig(
            name=name,
            storage_path=storage_path,
            stop=stop,
            failure_config=FailureConfig(max_failures=max_failures),
        ),
    )
    if resources_per_trial:
        tuner._resources_per_trial = resources_per_trial
    return tuner.fit()
