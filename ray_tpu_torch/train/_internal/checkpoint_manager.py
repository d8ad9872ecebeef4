"""Driver-side checkpoint retention (analog of the reference's
CheckpointManager, python/ray/train/_internal/checkpoint.py:41 +
air._internal.checkpoint_manager:251): persists rank-0 checkpoints under the
run directory with top-K retention scored by a metric."""

from __future__ import annotations

import os
import shutil
from dataclasses import dataclass

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import CheckpointConfig


@dataclass
class _Tracked:
    path: str
    score: float | None
    index: int


class CheckpointManager:
    def __init__(self, run_dir: str, config: CheckpointConfig | None = None):
        self.run_dir = run_dir
        self.config = config or CheckpointConfig()
        self._tracked: list[_Tracked] = []
        self._index = 0
        os.makedirs(run_dir, exist_ok=True)

    def register(self, checkpoint: Checkpoint, metrics: dict) -> str:
        path = os.path.join(self.run_dir, f"checkpoint_{self._index:06d}")
        checkpoint.to_directory(path)
        attr = self.config.checkpoint_score_attribute
        score = float(metrics[attr]) if attr and attr in metrics else None
        self._tracked.append(_Tracked(path, score, self._index))
        self._index += 1
        self._enforce_retention()
        return path

    def _enforce_retention(self):
        keep = self.config.num_to_keep
        if keep is None or len(self._tracked) <= keep:
            return
        attr = self.config.checkpoint_score_attribute
        if attr:
            reverse = self.config.checkpoint_score_order == "max"
            ordered = sorted(
                self._tracked,
                key=lambda t: (t.score if t.score is not None else float("-inf")),
                reverse=reverse,
            )
        else:
            ordered = sorted(self._tracked, key=lambda t: t.index, reverse=True)
        for victim in ordered[keep:]:
            shutil.rmtree(victim.path, ignore_errors=True)
            self._tracked.remove(victim)

    @property
    def latest(self) -> Checkpoint | None:
        if not self._tracked:
            return None
        newest = max(self._tracked, key=lambda t: t.index)
        return Checkpoint.from_directory(newest.path)

    @property
    def best(self) -> Checkpoint | None:
        attr = self.config.checkpoint_score_attribute
        scored = [t for t in self._tracked if t.score is not None]
        if not attr or not scored:
            return self.latest
        reverse = self.config.checkpoint_score_order == "max"
        best = sorted(scored, key=lambda t: t.score, reverse=reverse)[0]
        return Checkpoint.from_directory(best.path)
