"""Per-trial result loggers (analog of reference python/ray/tune/logger/:
CSVLoggerCallback, JsonLoggerCallback, TBXLoggerCallback).

The controller drives a LoggerManager: every trial gets
``<experiment_dir>/<trial_id>/{progress.csv, result.json, events.out...}``
so sweeps are inspectable with pandas/jq/tensorboard exactly like the
reference's trial dirs.
"""

from __future__ import annotations

import csv
import json
import logging
import os
from typing import Optional

logger = logging.getLogger(__name__)


class Logger:
    def on_result(self, trial, result: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


def _scalars(result: dict) -> dict:
    return {
        k: v
        for k, v in result.items()
        if isinstance(v, (int, float)) and not isinstance(v, bool)
    }


class CSVLogger(Logger):
    """progress.csv — one row per reported result; the header is the union
    of keys seen on the FIRST result (later novel keys are dropped, same as
    the reference's CSV logger)."""

    def __init__(self, trial_dir: str):
        self.path = os.path.join(trial_dir, "progress.csv")
        self._file = None
        self._writer: Optional[csv.DictWriter] = None

    def on_result(self, trial, result):
        row = _scalars(result)
        if self._writer is None:
            self._file = open(self.path, "w", newline="")
            self._writer = csv.DictWriter(self._file, fieldnames=list(row))
            self._writer.writeheader()
        self._writer.writerow({k: row.get(k, "") for k in self._writer.fieldnames})
        self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()


class JsonLogger(Logger):
    """result.json — one JSON object per line, full (serializable) result."""

    def __init__(self, trial_dir: str):
        self.path = os.path.join(trial_dir, "result.json")
        self._file = open(self.path, "a")

    def on_result(self, trial, result):
        safe = {}
        for k, v in result.items():
            try:
                json.dumps(v)
                safe[k] = v
            except (TypeError, ValueError):
                safe[k] = repr(v)
        self._file.write(json.dumps(safe) + "\n")
        self._file.flush()

    def close(self):
        self._file.close()


class TBXLogger(Logger):
    """TensorBoard event files via tensorboardX, where it is installed; the
    LoggerManager skips this logger quietly where it is not."""

    def __init__(self, trial_dir: str):
        from tensorboardX import SummaryWriter

        self._writer = SummaryWriter(logdir=trial_dir)

    def on_result(self, trial, result):
        step = int(result.get("training_iteration", 0))
        for k, v in _scalars(result).items():
            if k == "training_iteration":
                continue
            try:
                self._writer.add_scalar(k, float(v), global_step=step)
            except Exception:
                pass

    def close(self):
        try:
            self._writer.close()
        except Exception:
            pass


DEFAULT_LOGGERS = (CSVLogger, JsonLogger, TBXLogger)


class LoggerManager:
    def __init__(self, experiment_dir: str, logger_classes=DEFAULT_LOGGERS):
        self.experiment_dir = experiment_dir
        self.logger_classes = logger_classes
        self._per_trial: dict[str, list[Logger]] = {}

    def _loggers_for(self, trial) -> list[Logger]:
        existing = self._per_trial.get(trial.trial_id)
        if existing is not None:
            return existing
        trial_dir = os.path.join(self.experiment_dir, trial.trial_id)
        os.makedirs(trial_dir, exist_ok=True)
        with open(os.path.join(trial_dir, "params.json"), "w") as f:
            try:
                json.dump(trial.config, f, default=repr)
            except Exception:
                pass
        loggers = []
        for cls in self.logger_classes:
            try:
                loggers.append(cls(trial_dir))
            except Exception as e:
                logger.debug("logger %s unavailable: %s", cls.__name__, e)
        self._per_trial[trial.trial_id] = loggers
        return loggers

    def on_result(self, trial, result: dict):
        for lg in self._loggers_for(trial):
            try:
                lg.on_result(trial, result)
            except Exception:
                logger.debug("logger failed", exc_info=True)

    def close(self):
        for loggers in self._per_trial.values():
            for lg in loggers:
                lg.close()
        self._per_trial.clear()
