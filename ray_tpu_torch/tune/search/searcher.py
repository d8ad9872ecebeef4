"""Searcher base + ConcurrencyLimiter (analog of reference
python/ray/tune/search/{searcher.py,concurrency_limiter.py})."""

from __future__ import annotations


class Searcher:
    """Suggests configs; learns from completed trials."""

    def __init__(self, metric: str | None = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def set_search_properties(self, metric: str | None, mode: str | None, config: dict) -> bool:
        if metric:
            self.metric = metric
        if mode:
            self.mode = mode
        return True

    def suggest(self, trial_id: str) -> dict | None:
        """Next config, or None = exhausted, or FINISHED sentinel."""
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: dict) -> None:
        pass

    def on_trial_complete(self, trial_id: str, result: dict | None = None, error: bool = False) -> None:
        pass

    @property
    def total_samples(self) -> int | None:
        """Total trials this searcher will produce, if known."""
        return None


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions from the wrapped searcher."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        super().__init__(searcher.metric, searcher.mode)
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set[str] = set()

    def set_search_properties(self, metric, mode, config):
        return self.searcher.set_search_properties(metric, mode, config)

    def suggest(self, trial_id):
        if len(self._live) >= self.max_concurrent:
            return None
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def on_trial_result(self, trial_id, result):
        self.searcher.on_trial_result(trial_id, result)

    def on_trial_complete(self, trial_id, result=None, error=False):
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result, error)

    @property
    def total_samples(self):
        return self.searcher.total_samples
