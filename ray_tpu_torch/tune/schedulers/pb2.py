"""PB2 — Population Based Bandits (GP-guided PBT explore step).

Reference: python/ray/tune/schedulers/pb2.py (+pb2_utils.py): PBT's exploit
keeps copying top-quantile checkpoints, but explore replaces the random
×1.2/×0.8 perturbation with a GP-UCB bandit over the hyperparameter box:
fit a GP on (normalized hyperparams → reward improvement per interval)
observations, pick the candidate maximizing mu + kappa*sigma. The reference
wraps GPy; this build fits the port's own Gaussian process (``tune/search/
_gp.py``: the fit scikit-learn's GaussianProcessRegressor makes in the JAX
package, in numpy and scipy).
Only numeric bounded hyperparameters participate (same constraint as the
reference — PB2 requires a continuous box).
"""

from __future__ import annotations

import math

import numpy as np

from ray_tpu_torch.tune import sample as s
from ray_tpu_torch.tune.schedulers.pbt import PopulationBasedTraining


def _bounds_of(spec) -> tuple[float, float, bool] | None:
    """(lower, upper, log) for a numeric domain / [lo, hi] list, else None."""
    if isinstance(spec, (s.Float, s.Integer)):
        return float(spec.lower), float(spec.upper), bool(getattr(spec, "log", False))
    if isinstance(spec, list) and len(spec) == 2 and all(
        isinstance(v, (int, float)) and not isinstance(v, bool) for v in spec
    ):
        return float(min(spec)), float(max(spec)), False
    return None


class PB2(PopulationBasedTraining):
    def __init__(self, *args, ucb_kappa: float = 2.0, candidates: int = 256, **kwargs):
        super().__init__(*args, **kwargs)
        self.ucb_kappa = ucb_kappa
        self.n_candidates = candidates
        self._box: dict[str, tuple[float, float, bool]] = {
            k: b for k, v in self.mutations.items() if (b := _bounds_of(v)) is not None
        }
        # Observations: normalized hyperparam vector -> reward delta over the
        # last perturbation interval.
        self._obs_X: list[list[float]] = []
        self._obs_y: list[float] = []
        self._last_metric: dict[str, float] = {}

    def _to_unit(self, config: dict) -> list[float]:
        x = []
        for k, (lo, hi, log) in self._box.items():
            v = float(config.get(k, lo))
            if log:
                u = (math.log(max(v, 1e-12)) - math.log(lo)) / (math.log(hi) - math.log(lo))
            else:
                u = (v - lo) / (hi - lo or 1.0)
            x.append(min(max(u, 0.0), 1.0))
        return x

    def _from_unit(self, x: np.ndarray, template: dict) -> dict:
        new = dict(template)
        for (k, (lo, hi, log)), u in zip(self._box.items(), x):
            if log:
                v = math.exp(math.log(lo) + float(u) * (math.log(hi) - math.log(lo)))
            else:
                v = lo + float(u) * (hi - lo)
            v = min(max(v, lo), hi)  # clamp to the declared box, nothing else
            spec = self.mutations[k]
            if isinstance(spec, s.Integer) or (
                isinstance(new.get(k), int) and not isinstance(new.get(k), bool)
            ):
                v = min(max(int(round(v)), int(math.ceil(lo))), int(math.floor(hi)))
            new[k] = v
        return new

    def on_trial_result(self, controller, trial, result):
        # Record reward deltas for the GP before PBT's exploit logic runs.
        if self.metric and self.metric in result:
            cur = float(result[self.metric]) * (1.0 if self.mode == "max" else -1.0)
            prev = self._last_metric.get(trial.trial_id)
            if prev is not None:
                self._obs_X.append(self._to_unit(trial.config))
                self._obs_y.append(cur - prev)
            self._last_metric[trial.trial_id] = cur
        return super().on_trial_result(controller, trial, result)

    def explore(self, config: dict) -> dict:
        if not self._box:
            return super().explore(config)
        new = super().explore(config)  # handles categorical/list mutations
        if len(self._obs_X) < 4:
            # Not enough observations for a GP: random point in the box.
            u = np.random.default_rng(self.rng.randint(0, 1 << 31)).random(len(self._box))
            return self._from_unit(u, new)
        from ray_tpu_torch.tune.search._gp import GaussianProcess

        X = np.asarray(self._obs_X[-256:])  # bounded window, recent behaviour
        y = np.asarray(self._obs_y[-256:])
        y = (y - y.mean()) / (y.std() + 1e-9)
        # The reference seeds its regressor from this stream (unused with no
        # optimizer restarts): draw it too, so the streams stay aligned.
        self.rng.randint(0, 1 << 31)
        gp = GaussianProcess(alpha=1e-4).fit(X, y)
        rng = np.random.default_rng(self.rng.randint(0, 1 << 31))
        cand = rng.random((self.n_candidates, len(self._box)))
        mu, sigma = gp.predict(cand)
        best = cand[int(np.argmax(mu + self.ucb_kappa * sigma))]
        return self._from_unit(best, new)
