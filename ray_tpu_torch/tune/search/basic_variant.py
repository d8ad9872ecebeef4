"""Grid/random variant generation (analog of reference
python/ray/tune/search/basic_variant.py — grid_search cross-product ×
num_samples random repetitions)."""

from __future__ import annotations

import itertools
import random

from ray_tpu_torch.tune import sample as s
from ray_tpu_torch.tune.search.searcher import Searcher


class BasicVariantGenerator(Searcher):
    def __init__(self, param_space: dict | None = None, num_samples: int = 1, seed: int | None = None):
        super().__init__()
        self.param_space = param_space or {}
        self.num_samples = num_samples
        self.rng = random.Random(seed)
        self._queue: list[dict] | None = None
        self._idx = 0

    def set_search_properties(self, metric, mode, config):
        super().set_search_properties(metric, mode, config)
        if config:
            self.param_space = config
        return True

    def _materialise(self):
        axes = s.grid_axes(self.param_space)
        assignments: list[dict] = [{}]
        if axes:
            paths, value_lists = zip(*axes)
            assignments = [
                dict(zip(paths, combo)) for combo in itertools.product(*value_lists)
            ]
        self._queue = [
            s.resolve(self.param_space, self.rng, ga)
            for _ in range(self.num_samples)
            for ga in assignments
        ]

    def suggest(self, trial_id):
        if self._queue is None:
            self._materialise()
        if self._idx >= len(self._queue):
            return None
        cfg = self._queue[self._idx]
        self._idx += 1
        return cfg

    @property
    def total_samples(self):
        if self._queue is None:
            self._materialise()
        return len(self._queue)
