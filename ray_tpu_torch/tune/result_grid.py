"""ResultGrid (analog of reference python/ray/tune/result_grid.py)."""

from __future__ import annotations

from ray_tpu_torch.train.base_trainer import Result


class ResultGrid:
    def __init__(self, results: list[Result], trials: list | None = None,
                 default_metric: str | None = None, default_mode: str | None = None):
        self._results = results
        self._trials = trials or []
        self._default_metric = default_metric
        self._default_mode = default_mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> list[str]:
        return [r.error for r in self._results if r.error]

    def get_best_result(self, metric: str | None = None, mode: str | None = None) -> Result:
        metric = metric or self._default_metric
        mode = mode or self._default_mode or "max"
        scored = [
            (r, r.metrics.get(metric)) for r in self._results if r.metrics.get(metric) is not None
        ]
        if not scored:
            ok = [r for r in self._results if not r.error]
            if ok:
                return ok[0]
            raise ValueError(f"no trial reported metric {metric!r}")
        sign = 1 if mode == "max" else -1
        return max(scored, key=lambda rv: sign * rv[1])[0]

    def get_dataframe(self):
        try:
            import pandas as pd
        except ImportError as e:  # pragma: no cover
            raise ImportError("pandas not available") from e
        return pd.DataFrame([dict(r.metrics, error=r.error) for r in self._results])
