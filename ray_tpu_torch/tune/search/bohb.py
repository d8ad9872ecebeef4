"""BOHB searcher — KDE density-ratio model (Falkner et al. 2018).

Analog of the reference's TuneBOHB (python/ray/tune/search/bohb/) but
self-contained: no ConfigSpace/hpbandster dependency. The TPE-like model:
observations split into "good" (top ``gamma`` fraction) and "bad"; a
per-dimension Gaussian KDE is fit to each over the unit hypercube (reusing
the bayesopt module's domain mapping); candidates sample from the good KDE
and the suggestion maximizes l(x)/g(x). Observations are bucketed by
budget (training_iteration) and the model uses the LARGEST budget with
enough points — the BOHB rule, so early HyperBand rungs inform the model
until higher-fidelity data accumulates. Pair with HyperBandForBOHB (or any
scheduler; the searcher is budget-aware on its own).
"""

from __future__ import annotations

import math
import random
from typing import Optional

import numpy as np

from ray_tpu_torch.tune import sample as s
from ray_tpu_torch.tune.search.bayesopt import _Dim
from ray_tpu_torch.tune.search.searcher import Searcher


class TuneBOHB(Searcher):
    def __init__(
        self,
        space: Optional[dict] = None,
        metric: Optional[str] = None,
        mode: str = "max",
        min_points: int = 8,
        gamma: float = 0.25,
        candidates_per_suggest: int = 64,
        random_fraction: float = 0.2,
        seed: Optional[int] = None,
    ):
        super().__init__(metric, mode)
        self._space = space
        self._dims: Optional[list] = None
        self.min_points = min_points
        self.gamma = gamma
        self.n_candidates = candidates_per_suggest
        self.random_fraction = random_fraction
        self.rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self._passthrough: dict = {}
        # budget (training_iteration) -> list of (unit-cube x, metric)
        self._obs: dict[int, list] = {}
        self._live: dict[str, list] = {}  # trial_id -> unit x

    def set_search_properties(self, metric, mode, config) -> bool:
        super().set_search_properties(metric, mode, config)
        if self._space is None and config:
            self._space = config
        return True

    def _build_dims(self):
        if self._dims is None:
            self._dims = []
            self._passthrough: dict = {}
            for key, dom in (self._space or {}).items():
                if isinstance(dom, (s.Float, s.Integer, s.Categorical)):
                    self._dims.append(_Dim(key, dom))
                elif isinstance(dom, s.GridSearch):
                    raise ValueError("grid_search is not supported by TuneBOHB")
                else:
                    # Constants + sample_from markers resolve at suggest
                    # time (same contract as BayesOptSearch).
                    self._passthrough[key] = dom
        return self._dims

    def _config_from_unit(self, x: list) -> dict:
        cfg = dict(self._passthrough)
        for dim, u in zip(self._dims, x):
            cfg[dim.key] = dim.from_unit(u)
        for key, v in list(cfg.items()):
            if isinstance(v, s.SampleFrom):
                cfg[key] = v.func(s._Spec(cfg))
        return cfg

    def _random_unit(self) -> list:
        return [self.rng.random() for _ in self._build_dims()]

    def _model_budget(self) -> Optional[int]:
        """Largest budget holding enough observations (the BOHB rule)."""
        for budget in sorted(self._obs, reverse=True):
            if len(self._obs[budget]) >= self.min_points:
                return budget
        return None

    @staticmethod
    def _kde_logpdf(points: np.ndarray, x: np.ndarray) -> float:
        """Sum over dims of 1-D Gaussian KDE log densities (bandwidth by
        Scott's rule, floored so a degenerate dim can't yield inf)."""
        n, d = points.shape
        bw = max(n ** (-1.0 / (d + 4)), 1e-3) * 0.5
        logp = 0.0
        for j in range(d):
            diffs = (x[j] - points[:, j]) / bw
            dens = np.exp(-0.5 * diffs**2).mean() / (bw * math.sqrt(2 * math.pi))
            logp += math.log(max(dens, 1e-12))
        return logp

    def _sample_from(self, points: np.ndarray) -> list:
        """Draw one candidate from the KDE: pick a kernel center, add
        bandwidth noise, clip to the cube."""
        n, d = points.shape
        center = points[int(self._np_rng.integers(0, n))]
        bw = max(n ** (-1.0 / (d + 4)), 1e-3) * 0.5
        x = center + self._np_rng.normal(0.0, bw, d)
        return np.clip(x, 0.0, 1.0).tolist()

    def suggest(self, trial_id: str) -> Optional[dict]:
        dims = self._build_dims()
        if not dims:
            return dict(self._space or {})
        budget = self._model_budget()
        if budget is None or self.rng.random() < self.random_fraction:
            x = self._random_unit()
        else:
            obs = self._obs[budget]
            sign = 1.0 if self.mode == "max" else -1.0
            ranked = sorted(obs, key=lambda o: sign * o[1], reverse=True)
            n_good = max(2, int(len(ranked) * self.gamma))
            good = np.asarray([o[0] for o in ranked[:n_good]])
            bad = np.asarray([o[0] for o in ranked[n_good:]] or [self._random_unit()])
            best_x, best_score = None, -math.inf
            for _ in range(self.n_candidates):
                cand = np.asarray(self._sample_from(good))
                score = self._kde_logpdf(good, cand) - self._kde_logpdf(bad, cand)
                if score > best_score:
                    best_x, best_score = cand.tolist(), score
            x = best_x
        self._live[trial_id] = x
        return self._config_from_unit(x)

    def _record(self, trial_id: str, result: Optional[dict]):
        if not result or self.metric is None:
            return
        value = result.get(self.metric)
        x = self._live.get(trial_id)
        if value is None or x is None:
            return
        budget = int(result.get("training_iteration", 1))
        self._obs.setdefault(budget, []).append((x, float(value)))

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        # Every milestone report is a budget-tagged observation — this is
        # what lets low rungs seed the model before full-budget data
        # exists. The final result arrives through here too, so
        # on_trial_complete must NOT re-record it (the controller passes
        # the same merged dict — recording twice would double-weight the
        # point in the KDEs and double-count toward min_points).
        self._record(trial_id, result)

    def on_trial_complete(self, trial_id: str, result=None, error: bool = False) -> None:
        self._live.pop(trial_id, None)
