"""Algorithm callbacks.

Reference: rllib/algorithms/callbacks.py (DefaultCallbacks): user hook
points invoked by the Algorithm at lifecycle milestones. The subset here
covers the hooks the runtime actually fires — init, train-result,
checkpoint save/load, evaluation — each receiving the algorithm so user
code can reach workers/weights/config.
"""

from __future__ import annotations


class DefaultCallbacks:
    """Subclass and override; pass the CLASS via
    ``config.callbacks(MyCallbacks)`` (reference: AlgorithmConfig.callbacks)."""

    def on_algorithm_init(self, *, algorithm) -> None:
        pass

    def on_train_result(self, *, algorithm, result: dict) -> None:
        """Called after every train(); may mutate `result` in place."""

    def on_evaluate_end(self, *, algorithm, evaluation_metrics: dict) -> None:
        pass

    def on_checkpoint_saved(self, *, algorithm, checkpoint) -> None:
        pass

    def on_checkpoint_loaded(self, *, algorithm) -> None:
        pass


def make_callbacks(callbacks_class) -> DefaultCallbacks:
    if callbacks_class is None:
        return DefaultCallbacks()
    cb = callbacks_class() if isinstance(callbacks_class, type) else callbacks_class
    assert isinstance(cb, DefaultCallbacks), (
        "callbacks must subclass ray_tpu_torch.rllib.callbacks.DefaultCallbacks"
    )
    return cb
