"""TuneConfig (analog of reference python/ray/tune/tune_config.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class TuneConfig:
    metric: str | None = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int | None = None
    search_alg: Any = None  # Searcher
    scheduler: Any = None  # TrialScheduler
    time_budget_s: float | None = None
    reuse_actors: bool = False
    trial_name_creator: Any = None
