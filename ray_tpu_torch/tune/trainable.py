"""Trainable protocol (analog of reference python/ray/tune/trainable/
trainable.py:69 — class API with setup/step/save_checkpoint/load_checkpoint).

A trial actor hosts exactly one Trainable; the class API is stepwise and
synchronous. The function API (``FunctionTrainable``, ``wrap_function``,
``tune.report``, ``tune.get_checkpoint``) comes with the Tuner that drives it
(ROADMAP A14).
"""

from __future__ import annotations

import time

from ray_tpu_torch.air.checkpoint import Checkpoint

RESULT_DONE = "done"
TRAINING_ITERATION = "training_iteration"


class Trainable:
    """Stepwise trainable (class API)."""

    def __init__(self, config: dict | None = None):
        self.config = config or {}
        self.iteration = 0
        self._start = time.time()
        self._trial_resources: dict = {}
        self.setup(self.config)

    @property
    def trial_resources(self) -> dict:
        """Resources currently allocated to this trial (reference:
        Trainable.trial_resources). Updated by the controller on every
        actor (re)start, so a ResourceChangingScheduler resize is visible
        from step() after the restart — read it there, not in setup()."""
        return self._trial_resources

    # -- subclass surface ---------------------------------------------------
    def setup(self, config: dict) -> None:
        pass

    def step(self) -> dict:
        raise NotImplementedError

    def save_checkpoint(self) -> Checkpoint | None:
        return None

    def load_checkpoint(self, checkpoint: Checkpoint) -> None:
        pass

    def reset_config(self, new_config: dict) -> bool:
        """Reuse this instance for a new config (PBT exploit). Return True if
        supported; False forces actor recreation."""
        return False

    def cleanup(self) -> None:
        pass

    # -- controller surface -------------------------------------------------
    def train(self) -> dict:
        result = self.step() or {}
        self.iteration += 1
        result.setdefault(TRAINING_ITERATION, self.iteration)
        result.setdefault("time_total_s", time.time() - self._start)
        result.setdefault(RESULT_DONE, False)
        return result

    def save(self) -> Checkpoint | None:
        ckpt = self.save_checkpoint()
        if ckpt is not None:
            ckpt.metadata.setdefault(TRAINING_ITERATION, self.iteration)
        return ckpt

    def restore(self, checkpoint: Checkpoint) -> None:
        self.load_checkpoint(checkpoint)
        it = checkpoint.metadata.get(TRAINING_ITERATION) if checkpoint else None
        if it is not None:
            self.iteration = int(it)

    def stop(self) -> None:
        self.cleanup()
