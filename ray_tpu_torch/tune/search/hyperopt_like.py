"""Native model-based searcher (fills the role of the reference's wrapped BO
libraries — python/ray/tune/search/{hyperopt,bayesopt,optuna,...} — without
external dependencies).

TPE-flavoured: split observed trials into good/bad quantiles, then prefer
candidates (drawn from the raw space) whose numeric coordinates are nearer the
good set than the bad set. Falls back to pure random while fewer than
``n_initial_points`` observations exist.
"""

from __future__ import annotations

import math
import random

from ray_tpu_torch.tune import sample as s
from ray_tpu_torch.tune.search.searcher import Searcher


def _flatten(cfg: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in cfg.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out[key] = float(v)
    return out


class HyperOptLikeSearch(Searcher):
    def __init__(
        self,
        space: dict | None = None,
        metric: str | None = None,
        mode: str = "max",
        n_initial_points: int = 5,
        n_candidates: int = 32,
        gamma: float = 0.25,
        seed: int | None = None,
    ):
        super().__init__(metric, mode)
        self.space = space or {}
        self.n_initial_points = n_initial_points
        self.n_candidates = n_candidates
        self.gamma = gamma
        self.rng = random.Random(seed)
        self._observed: list[tuple[dict, float]] = []  # (flat config, score)
        self._live: dict[str, dict] = {}

    def set_search_properties(self, metric, mode, config):
        super().set_search_properties(metric, mode, config)
        if config and not self.space:
            self.space = config
        return True

    def _score(self, result: dict) -> float | None:
        v = result.get(self.metric) if self.metric else None
        if v is None:
            return None
        return float(v) if self.mode == "max" else -float(v)

    def _distance(self, a: dict, b: dict, scales: dict) -> float:
        keys = set(a) | set(b)
        d = 0.0
        for k in keys:
            av, bv = a.get(k), b.get(k)
            if av is None or bv is None:
                d += 1.0
                continue
            sc = scales.get(k) or 1.0
            d += ((av - bv) / sc) ** 2
        return math.sqrt(d)

    def suggest(self, trial_id):
        cfg = s.resolve(self.space, self.rng)
        if len(self._observed) >= self.n_initial_points:
            ranked = sorted(self._observed, key=lambda t: -t[1])
            n_good = max(1, int(len(ranked) * self.gamma))
            good = [c for c, _ in ranked[:n_good]]
            bad = [c for c, _ in ranked[n_good:]] or good
            allv: dict[str, list[float]] = {}
            for c, _ in self._observed:
                for k, v in c.items():
                    allv.setdefault(k, []).append(v)
            scales = {
                k: (max(vs) - min(vs)) or 1.0 for k, vs in allv.items()
            }
            best, best_score = cfg, -math.inf
            for _ in range(self.n_candidates):
                cand = s.resolve(self.space, self.rng)
                flat = _flatten(cand)
                dg = min(self._distance(flat, g, scales) for g in good)
                db = min(self._distance(flat, b, scales) for b in bad)
                score = db - dg  # near good, far from bad
                if score > best_score:
                    best, best_score = cand, score
            cfg = best
        self._live[trial_id] = cfg
        return cfg

    def on_trial_complete(self, trial_id, result=None, error=False):
        cfg = self._live.pop(trial_id, None)
        if cfg is None or error or not result:
            return
        score = self._score(result)
        if score is not None:
            self._observed.append((_flatten(cfg), score))
