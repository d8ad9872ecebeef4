"""Population Based Training (analog of reference python/ray/tune/schedulers/
pbt.py PopulationBasedTraining).

Every ``perturbation_interval`` iterations a trial in the bottom quantile
exploits a top-quantile trial: it clones that trial's latest checkpoint and
config, then explores by perturbing hyperparameters (×1.2 / ×0.8 for numeric,
resample for domains). The controller applies the exploit by restarting the
trial actor with the new config + donor checkpoint.
"""

from __future__ import annotations

import random

from ray_tpu_torch.tune import sample as s
from ray_tpu_torch.tune.schedulers.trial_scheduler import CONTINUE, TrialScheduler

EXPLOIT = "EXPLOIT"  # extra decision understood by the controller


class PopulationBasedTraining(TrialScheduler):
    def __init__(
        self,
        metric: str | None = None,
        mode: str = "max",
        perturbation_interval: int = 5,
        hyperparam_mutations: dict | None = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: int | None = None,
        time_attr: str = "training_iteration",
    ):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.rng = random.Random(seed)
        self.time_attr = time_attr
        self._last_perturb: dict[str, int] = {}
        # set by on_trial_result when EXPLOIT is returned; consumed by controller
        self.pending_exploit: dict[str, tuple] = {}  # trial_id -> (donor_trial, new_config)

    def _signed(self, trial) -> float | None:
        v = trial.last_result.get(self.metric) if self.metric else None
        if v is None:
            return None
        return float(v) if self.mode == "max" else -float(v)

    def explore(self, config: dict) -> dict:
        new = dict(config)
        for key, spec in self.mutations.items():
            cur = new.get(key)
            if self.rng.random() < self.resample_p or cur is None:
                if isinstance(spec, s.Domain):
                    new[key] = spec.sample(self.rng)
                elif isinstance(spec, list):
                    new[key] = self.rng.choice(spec)
                elif callable(spec):
                    new[key] = spec()
                continue
            if isinstance(cur, (int, float)) and not isinstance(cur, bool):
                factor = 1.2 if self.rng.random() > 0.5 else 0.8
                new[key] = type(cur)(cur * factor) if isinstance(cur, float) else max(1, int(cur * factor))
            elif isinstance(spec, list) and cur in spec:
                i = spec.index(cur)
                new[key] = spec[max(0, min(len(spec) - 1, i + self.rng.choice([-1, 1])))]
        return new

    def on_trial_result(self, controller, trial, result):
        t = int(result.get(self.time_attr, 0))
        if self.metric is None or self.metric not in result:
            return CONTINUE
        if t - self._last_perturb.get(trial.trial_id, 0) < self.interval:
            return CONTINUE
        self._last_perturb[trial.trial_id] = t

        scored = [(tr, sv) for tr in controller.trials if (sv := self._signed(tr)) is not None]
        if len(scored) < 2:
            return CONTINUE
        scored.sort(key=lambda x: x[1])
        n_q = max(1, int(len(scored) * self.quantile))
        bottom = [tr for tr, _ in scored[:n_q]]
        top = [tr for tr, _ in scored[-n_q:]]
        if trial not in bottom or trial in top:
            return CONTINUE
        donor = self.rng.choice(top)
        if donor.trial_id == trial.trial_id or donor.checkpoint is None:
            return CONTINUE
        new_config = self.explore(donor.config)
        self.pending_exploit[trial.trial_id] = (donor, new_config)
        return EXPLOIT
