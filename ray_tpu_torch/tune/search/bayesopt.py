"""GP-based Bayesian optimization searcher.

Analog of the reference's BayesOptSearch wrapper (python/ray/tune/search/
bayesopt/bayesopt_search.py) — but self-contained on the port's own Gaussian
process (``_gp.py``, numpy and scipy: the fit scikit-learn's
GaussianProcessRegressor makes in the JAX package) instead of the external
`bayesian-optimization` package: expected-improvement acquisition maximized
over random candidates, with Float/Integer/Categorical domains mapped to a
unit hypercube (categoricals one-hot-ish via index coordinates, log domains
searched in log space).
"""

from __future__ import annotations

import math
import random

import numpy as np

from ray_tpu_torch.tune import sample as s
from ray_tpu_torch.tune.search.searcher import Searcher


class _Dim:
    """One search dimension <-> one [0,1] coordinate."""

    def __init__(self, key: str, domain):
        self.key = key
        self.domain = domain

    def to_unit(self, value) -> float:
        d = self.domain
        if isinstance(d, s.Categorical):
            return d.categories.index(value) / max(len(d.categories) - 1, 1)
        lo, hi = float(d.lower), float(d.upper)
        if getattr(d, "log", False):
            return (math.log(float(value)) - math.log(lo)) / (math.log(hi) - math.log(lo))
        return (float(value) - lo) / (hi - lo)

    def from_unit(self, u: float):
        d = self.domain
        u = min(max(u, 0.0), 1.0)
        if isinstance(d, s.Categorical):
            return d.categories[int(round(u * (len(d.categories) - 1)))]
        lo, hi = float(d.lower), float(d.upper)
        if getattr(d, "log", False):
            v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        else:
            v = lo + u * (hi - lo)
        if getattr(d, "q", None):
            v = round(v / d.q) * d.q
        if isinstance(d, s.Integer):
            return int(round(v))
        return float(v)


class BayesOptSearch(Searcher):
    def __init__(
        self,
        space: dict | None = None,
        metric: str | None = None,
        mode: str = "max",
        random_startup_trials: int = 5,
        candidates_per_suggest: int = 256,
        seed: int | None = None,
    ):
        super().__init__(metric, mode)
        self._space = space
        self._dims: list[_Dim] | None = None
        self.startup = random_startup_trials
        self.n_candidates = candidates_per_suggest
        self.rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self._X: list[list[float]] = []
        self._y: list[float] = []
        self._live: dict[str, list[float]] = {}

    def set_search_properties(self, metric, mode, config):
        super().set_search_properties(metric, mode, config)
        if self._space is None and config:
            self._space = config
        return True

    def _build_dims(self):
        assert self._space, "BayesOptSearch needs a param_space"
        self._dims = []
        self._passthrough = {}
        for key, dom in self._space.items():
            if isinstance(dom, (s.Float, s.Integer, s.Categorical)):
                self._dims.append(_Dim(key, dom))
            elif isinstance(dom, s.GridSearch):
                raise ValueError("grid_search is not supported by BayesOptSearch")
            else:
                self._passthrough[key] = dom
        if not self._dims:
            raise ValueError("param_space has no sampleable domains")

    def _config_from_unit(self, x: list[float]) -> dict:
        cfg = dict(self._passthrough)
        for dim, u in zip(self._dims, x):
            cfg[dim.key] = dim.from_unit(u)
        # sample_from markers resolve against the sampled values.
        for key, v in list(cfg.items()):
            if isinstance(v, s.SampleFrom):
                cfg[key] = v.func(s._Spec(cfg))
        return cfg

    def suggest(self, trial_id: str) -> dict | None:
        if self._dims is None:
            self._build_dims()
        d = len(self._dims)
        if len(self._X) < self.startup:
            x = [self.rng.random() for _ in range(d)]
        else:
            x = self._maximize_ei(d)
        self._live[trial_id] = x
        return self._config_from_unit(x)

    def _maximize_ei(self, d: int) -> list[float]:
        from scipy.stats import norm

        from ray_tpu_torch.tune.search._gp import GaussianProcess

        X = np.asarray(self._X)
        y = np.asarray(self._y)
        y_mu, y_sd = y.mean(), y.std() + 1e-9
        # The reference seeds its regressor from this stream (unused with no
        # optimizer restarts): draw it too, so the streams stay aligned.
        self.rng.randint(0, 1 << 31)
        gp = GaussianProcess(alpha=1e-6).fit(X, (y - y_mu) / y_sd)
        cand = self._np_rng.random((self.n_candidates, d))
        mu, sigma = gp.predict(cand)
        best = ((y - y_mu) / y_sd).max()
        imp = mu - best - 0.01
        z = imp / np.maximum(sigma, 1e-9)
        ei = imp * norm.cdf(z) + sigma * norm.pdf(z)
        return [float(v) for v in cand[int(np.argmax(ei))]]

    def on_trial_complete(self, trial_id, result=None, error=False):
        x = self._live.pop(trial_id, None)
        if x is None or error or not result or self.metric not in result:
            return
        v = float(result[self.metric])
        self._X.append(x)
        self._y.append(v if self.mode == "max" else -v)
