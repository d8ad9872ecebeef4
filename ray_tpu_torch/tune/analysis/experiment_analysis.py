"""Offline experiment analysis (analog of reference
python/ray/tune/analysis/experiment_analysis.py:55 ``ExperimentAnalysis``).

Loads a finished (or foreign, or interrupted) experiment purely from its
directory — no live TuneController required:

    <experiment_dir>/
      experiment_state.json          <- trial summaries (tune_controller.py)
      <trial_id>/params.json         <- trial config (logger.py LoggerManager)
      <trial_id>/result.json         <- one JSON object per reported result
      <trial_id>/progress.csv        <- same rows, CSV
      checkpoint_<trial_id>/         <- latest persisted Checkpoint

``Tuner.restore`` and this class share the same on-disk schema; anything a
previous process wrote is enough.
"""

from __future__ import annotations

import json
import os
from typing import Any

from ray_tpu_torch.air.checkpoint import Checkpoint


class _TrialRecord:
    """One trial as reconstructed from disk."""

    def __init__(self, trial_id: str, experiment_dir: str, summary: dict):
        self.trial_id = trial_id
        self.experiment_dir = experiment_dir
        self.summary = summary
        self.logdir = os.path.join(experiment_dir, trial_id)

    @property
    def config(self) -> dict:
        params = os.path.join(self.logdir, "params.json")
        if os.path.exists(params):
            try:
                with open(params) as f:
                    return json.load(f)
            except (OSError, ValueError):
                pass
        return dict(self.summary.get("config") or {})

    @property
    def last_result(self) -> dict:
        rows = self.results()
        if rows:
            return rows[-1]
        return dict(self.summary.get("last_result") or {})

    def results(self) -> list[dict]:
        """All reported results, in report order (result.json lines)."""
        path = os.path.join(self.logdir, "result.json")
        rows: list[dict] = []
        if os.path.exists(path):
            try:
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if line:
                            rows.append(json.loads(line))
            except (OSError, ValueError):
                pass
        return rows

    @property
    def checkpoint(self) -> Checkpoint | None:
        ckpt_dir = os.path.join(self.experiment_dir, f"checkpoint_{self.trial_id}")
        if os.path.isdir(ckpt_dir):
            try:
                return Checkpoint.from_directory(ckpt_dir)
            except Exception:
                return None
        return None


class ExperimentAnalysis:
    """Analyze an experiment directory written by a (possibly finished,
    possibly foreign) Tune run. Reference:
    python/ray/tune/analysis/experiment_analysis.py:55."""

    def __init__(
        self,
        experiment_path: str,
        default_metric: str | None = None,
        default_mode: str | None = None,
    ):
        self.experiment_path = experiment_path
        state_path = os.path.join(experiment_path, "experiment_state.json")
        if not os.path.exists(state_path):
            raise FileNotFoundError(
                f"no experiment_state.json under {experiment_path!r} — not a "
                "Tune experiment directory"
            )
        with open(state_path) as f:
            self._state = json.load(f)
        self.default_metric = default_metric or self._state.get("metric")
        self.default_mode = default_mode or self._state.get("mode")
        if self.default_mode not in (None, "min", "max"):
            raise ValueError(f"mode must be 'min'|'max', got {self.default_mode!r}")
        self.trials = [
            _TrialRecord(ts["trial_id"], experiment_path, ts)
            for ts in self._state.get("trials", [])
        ]

    # -- whole-experiment views ---------------------------------------------

    @property
    def stats(self) -> dict:
        return {
            "experiment_name": self._state.get("experiment_name"),
            "timestamp": self._state.get("timestamp"),
            "num_trials": len(self.trials),
        }

    def get_all_configs(self) -> dict[str, dict]:
        return {t.trial_id: t.config for t in self.trials}

    @property
    def results(self) -> dict[str, dict]:
        """trial_id -> last reported result."""
        return {t.trial_id: t.last_result for t in self.trials}

    @property
    def trial_dataframes(self) -> dict[str, Any]:
        """trial_id -> DataFrame of every reported result, in order."""
        import pandas as pd

        return {t.trial_id: pd.DataFrame(t.results()) for t in self.trials}

    def dataframe(self, metric: str | None = None, mode: str | None = None):
        """One row per trial. With an EXPLICIT metric, each trial's row is
        its best report for that metric; otherwise its last report (the
        experiment's recorded default metric does not flip this — matching
        the reference API's last-report default)."""
        import pandas as pd

        explicit = metric is not None
        metric, mode = self._resolve(metric, mode, require=explicit)
        rows = []
        for t in self.trials:
            row = self._pick_row(t, metric, mode) if explicit else t.last_result
            row = dict(row)
            row["trial_id"] = t.trial_id
            row["logdir"] = t.logdir
            rows.append(row)
        return pd.DataFrame(rows)

    # -- best-* lookups ------------------------------------------------------

    def get_best_trial(
        self, metric: str | None = None, mode: str | None = None, scope: str = "last"
    ) -> _TrialRecord | None:
        """scope='last' compares final reports; 'all' compares each trial's
        best-ever report (reference get_best_trial scopes)."""
        metric, mode = self._resolve(metric, mode)
        sign = 1 if mode == "max" else -1
        best, best_v = None, None
        for t in self.trials:
            row = t.last_result if scope == "last" else self._pick_row(t, metric, mode)
            v = row.get(metric)
            if v is None:
                continue
            if best_v is None or sign * v > sign * best_v:
                best, best_v = t, v
        return best

    def get_best_config(
        self, metric: str | None = None, mode: str | None = None, scope: str = "last"
    ) -> dict | None:
        t = self.get_best_trial(metric, mode, scope)
        return t.config if t else None

    def get_best_logdir(
        self, metric: str | None = None, mode: str | None = None, scope: str = "last"
    ) -> str | None:
        t = self.get_best_trial(metric, mode, scope)
        return t.logdir if t else None

    def get_best_checkpoint(
        self, trial: _TrialRecord | None = None, metric: str | None = None, mode: str | None = None
    ) -> Checkpoint | None:
        """The persisted checkpoint of the best trial (or the given trial)."""
        if trial is None:
            trial = self.get_best_trial(metric, mode)
        return trial.checkpoint if trial else None

    @property
    def best_trial(self) -> _TrialRecord:
        t = self.get_best_trial()
        if t is None:
            raise ValueError("no trial reported the default metric")
        return t

    @property
    def best_config(self) -> dict:
        return self.best_trial.config

    @property
    def best_checkpoint(self) -> Checkpoint:
        ckpt = self.get_best_checkpoint()
        if ckpt is None:
            raise ValueError("best trial has no persisted checkpoint")
        return ckpt

    @property
    def best_result(self) -> dict:
        return self.best_trial.last_result

    @property
    def best_dataframe(self):
        import pandas as pd

        return pd.DataFrame(self.best_trial.results())

    # -- internals -----------------------------------------------------------

    def _resolve(self, metric, mode, require: bool = True):
        metric = metric or self.default_metric
        mode = mode or self.default_mode or "max"
        if require and not metric:
            raise ValueError(
                "no metric given and the experiment recorded no default metric"
            )
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min'|'max', got {mode!r}")
        return metric, mode

    def _pick_row(self, t: _TrialRecord, metric: str, mode: str) -> dict:
        sign = 1 if mode == "max" else -1
        best_row: dict = {}
        best_v = None
        for row in t.results():
            v = row.get(metric)
            if v is None:
                continue
            if best_v is None or sign * v > sign * best_v:
                best_row, best_v = row, v
        return best_row or t.last_result
