"""Preprocessor base.

Analog of the reference's ``ray.data.preprocessor.Preprocessor``
(python/ray/data/preprocessor.py): stateful fit over a Dataset, stateless
transform of Datasets and batches; fitted state rides inside AIR checkpoints
so Predictors can re-apply the same preprocessing at inference time.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ray_tpu_torch.data.dataset import Dataset


class PreprocessorNotFittedError(RuntimeError):
    pass


class Preprocessor:
    _is_fittable: bool = True

    def fit(self, ds: "Dataset") -> "Preprocessor":
        if self._is_fittable:
            self._fit(ds)
        self._fitted = True
        return self

    def fit_transform(self, ds: "Dataset") -> "Dataset":
        return self.fit(ds).transform(ds)

    def transform(self, ds: "Dataset") -> "Dataset":
        self._check_fitted()
        return ds.map_batches(self._transform_pandas_or_dict, batch_format="default")

    def transform_batch(self, batch: dict) -> dict:
        self._check_fitted()
        return self._transform_pandas_or_dict(batch)

    def _check_fitted(self):
        if self._is_fittable and not getattr(self, "_fitted", False):
            raise PreprocessorNotFittedError(
                f"{type(self).__name__} must be fit before transform"
            )

    # -- subclass hooks ------------------------------------------------
    def _fit(self, ds: "Dataset"):
        raise NotImplementedError

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        raise NotImplementedError
