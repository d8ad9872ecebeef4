"""Predictors — checkpoint → inference callable.

The port of the JAX package's ``train/predictor.py``, an analog of the
reference's ray.train.predictor.Predictor + batch_predictor.BatchPredictor
(python/ray/train/predictor.py, batch_predictor.py): a Predictor wraps a
checkpoint (+ optional fitted preprocessor) and maps batches to predictions;
BatchPredictor scales one over a Dataset with an actor pool so the model
stays resident per actor.

``TorchPredictor`` takes the place of ``JaxPredictor``: ``apply_fn(params,
inputs)`` with ``params`` (a dict of tensors) moved to the device once, when
the predictor is built (once per scoring actor), and each batch's inputs
placed on the same device; the apply function runs eagerly under
``torch.no_grad()``. Like the port's other entry points it runs on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ray_tpu_torch.air.checkpoint import Checkpoint, tensors_from_checkpoint


class Predictor:
    def __init__(self, preprocessor=None):
        self._preprocessor = preprocessor

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def get_preprocessor(self):
        return self._preprocessor

    def predict(self, batch: dict) -> dict:
        if self._preprocessor is not None:
            batch = self._preprocessor.transform_batch(batch)
        return self._predict(batch)

    def _predict(self, batch: dict) -> dict:
        raise NotImplementedError


def _on_device(tree, device):
    import torch

    if isinstance(tree, dict):
        return {k: _on_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(tree).to(device)


class TorchPredictor(Predictor):
    """Predictor over an apply fn + a dict of parameter tensors.

    ``apply_fn(params, inputs) -> outputs``; inputs are taken from
    ``input_column`` (default: the whole batch if it has one column) and
    placed on ``device``; outputs come back as numpy under
    ``"predictions"`` (bfloat16, which numpy lacks, as float32).
    """

    def __init__(
        self,
        params,
        apply_fn: Callable,
        preprocessor=None,
        input_column: Optional[str] = None,
        device="cuda",
    ):
        super().__init__(preprocessor)
        import torch

        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to predict on the CPU")
        self.params = _on_device(params, self.device)
        self.apply_fn = apply_fn
        self.input_column = input_column

    @classmethod
    def from_checkpoint(
        cls,
        checkpoint: Checkpoint,
        apply_fn: Callable | None = None,
        input_column: Optional[str] = None,
        device="cuda",
    ) -> "TorchPredictor":
        """``checkpoint`` holds the parameters under ``"params"`` (arrays or
        tensors) or as ``checkpoint_from_tensors`` stored them, and may hold
        ``apply_fn`` and a fitted ``preprocessor``."""
        data = checkpoint.to_dict()
        if "tensors" in data:
            params = tensors_from_checkpoint(checkpoint, device=device)
        else:
            params = data.get("params")
        if params is None:
            raise ValueError("checkpoint has no 'params' (or 'tensors') entry")
        fn = apply_fn or data.get("apply_fn")
        if fn is None:
            raise ValueError("pass apply_fn= or store one in the checkpoint")
        return cls(params, fn, preprocessor=data.get("preprocessor"), input_column=input_column, device=device)

    def _predict(self, batch: dict) -> dict:
        import torch

        if self.input_column is not None:
            inputs = batch[self.input_column]
        elif len(batch) == 1:
            inputs = next(iter(batch.values()))
        else:
            raise ValueError(
                f"batch has columns {sorted(batch)}; pass input_column= to pick one"
            )
        inputs = torch.from_numpy(np.array(inputs)).to(self.device)
        with torch.no_grad():
            out = self.apply_fn(self.params, inputs).cpu()
        if out.dtype == torch.bfloat16:
            out = out.float()
        return {"predictions": out.numpy()}


class BatchPredictor:
    """Scale a Predictor over a Dataset (reference: batch_predictor.py).

    One predictor instance per map actor: the checkpoint is deserialized and
    the model placed on the actor's device once per actor, then reused
    across batches.
    """

    def __init__(self, checkpoint: Checkpoint, predictor_cls, **predictor_kwargs):
        self.checkpoint = checkpoint
        self.predictor_cls = predictor_cls
        self.predictor_kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, predictor_cls, **kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **kwargs)

    def predict(
        self,
        ds,
        *,
        batch_size: int = 4096,
        min_scoring_workers: int = 1,
        max_scoring_workers: int = 2,
        num_gpus_per_worker: float = 0,
        keep_columns: Optional[list] = None,
    ):
        """``num_gpus_per_worker`` (the JAX package's ``num_tpus_per_worker``)
        is each scoring actor's share of the runtime's "GPU" resource."""
        from ray_tpu_torch.data import ActorPoolStrategy

        checkpoint_blob = self.checkpoint.to_bytes()
        predictor_cls = self.predictor_cls
        predictor_kwargs = self.predictor_kwargs

        class ScoringActor:
            def __init__(self):
                self.predictor = predictor_cls.from_checkpoint(
                    Checkpoint.from_bytes(checkpoint_blob), **predictor_kwargs
                )

            def __call__(self, batch: dict) -> dict:
                out = self.predictor.predict(dict(batch))
                for col in keep_columns or []:
                    out[col] = batch[col]
                return out

        return ds.map_batches(
            ScoringActor,
            batch_size=batch_size,
            # Actor-pool resources come from the strategy, not ray_remote_args.
            compute=ActorPoolStrategy(
                min_size=min_scoring_workers,
                max_size=max_scoring_workers,
                num_gpus=num_gpus_per_worker,
            ),
        )
