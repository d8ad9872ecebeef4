"""Repeater — evaluate each suggested config N times and report the mean.

Reference: python/ray/tune/search/repeater.py (Repeater + TrialGroup): wraps
a searcher so noisy objectives are averaged over `repeat` independent trials
before the underlying searcher learns from them.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.tune.search.searcher import Searcher


class _TrialGroup:
    def __init__(self, primary_id: str, config: dict, repeat: int):
        self.primary_id = primary_id
        self.config = config
        self.repeat = repeat
        self.scores: list[float] = []
        self.completed = 0

    def full(self) -> bool:
        return self.completed >= self.repeat


class Repeater(Searcher):
    def __init__(self, searcher: Searcher, repeat: int = 3, set_index: bool = True):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.repeat = repeat
        self.set_index = set_index
        self._groups: list[_TrialGroup] = []
        self._trial_group: dict[str, _TrialGroup] = {}
        self._current: _TrialGroup | None = None

    def set_search_properties(self, metric, mode, config):
        super().set_search_properties(metric, mode, config)
        return self.searcher.set_search_properties(metric, mode, config)

    def suggest(self, trial_id: str) -> dict | None:
        if self._current is None or self._current_assigned >= self.repeat:
            cfg = self.searcher.suggest(trial_id)
            if cfg is None:
                return None
            self._current = _TrialGroup(trial_id, cfg, self.repeat)
            self._current_assigned = 0
            self._groups.append(self._current)
        group = self._current
        self._trial_group[trial_id] = group
        cfg = dict(group.config)
        if self.set_index:
            cfg["__trial_index__"] = self._current_assigned
        self._current_assigned += 1
        return cfg

    _current_assigned = 0

    def on_trial_complete(self, trial_id: str, result=None, error: bool = False):
        group = self._trial_group.pop(trial_id, None)
        if group is None:
            return
        group.completed += 1
        if result and self.metric in result and not error:
            group.scores.append(float(result[self.metric]))
        if group.full():
            mean = float(np.mean(group.scores)) if group.scores else None
            self.searcher.on_trial_complete(
                group.primary_id,
                {self.metric: mean} if mean is not None else None,
                error=mean is None,
            )

    @property
    def total_samples(self):
        n = self.searcher.total_samples
        return n * self.repeat if n is not None else None
