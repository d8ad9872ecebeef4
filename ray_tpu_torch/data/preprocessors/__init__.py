"""Built-in preprocessors.

Analog of the reference's ray.data.preprocessors (python/ray/data/
preprocessors/{scaler.py,encoder.py,imputer.py,concatenator.py,
batch_mapper.py,chain.py}): scalers fitted via Dataset aggregates, categorical
encoders via unique(), imputation, column concatenation (the bridge to a
single feature matrix for one large matmul), arbitrary batch mapping, and
chaining.

Batches are dicts of numpy column arrays (this framework's default batch
format), so every transform is vectorized.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ray_tpu_torch.data.aggregate import AggregateFn, Max, Mean, Min, Std
from ray_tpu_torch.data.preprocessor import Preprocessor


def _safe_scale(x: float) -> float:
    """Scale denominator: NaN (e.g. Std of a 1-row fit) and 0 both mean
    'don't scale', never 'emit NaN columns silently'."""
    return 1.0 if (x is None or x == 0 or not np.isfinite(x)) else float(x)


class StandardScaler(Preprocessor):
    """(x - mean) / std per column (reference: preprocessors/scaler.py)."""

    def __init__(self, columns: list):
        self.columns = list(columns)

    def _fit(self, ds):
        # One distributed aggregation pass for every column's mean+std.
        aggs = []
        for col in self.columns:
            aggs += [Mean(col), Std(col)]
        res = ds.aggregate(*aggs)
        self.stats_ = {
            col: (res[f"mean({col})"], _safe_scale(res[f"std({col})"]))
            for col in self.columns
        }

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        for col in self.columns:
            mean, std = self.stats_[col]
            out[col] = (np.asarray(batch[col], dtype=np.float64) - mean) / std
        return out


class MinMaxScaler(Preprocessor):
    """(x - min) / (max - min) per column."""

    def __init__(self, columns: list):
        self.columns = list(columns)

    def _fit(self, ds):
        aggs = []
        for col in self.columns:
            aggs += [Min(col), Max(col)]
        res = ds.aggregate(*aggs)
        self.stats_ = {}
        for col in self.columns:
            lo, hi = res[f"min({col})"], res[f"max({col})"]
            self.stats_[col] = (lo, _safe_scale(hi - lo))

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        for col in self.columns:
            lo, span = self.stats_[col]
            out[col] = (np.asarray(batch[col], dtype=np.float64) - lo) / span
        return out


class LabelEncoder(Preprocessor):
    """Column of categories -> integer codes (reference: encoder.py)."""

    def __init__(self, label_column: str):
        self.label_column = label_column

    def _fit(self, ds):
        self.classes_ = sorted(ds.unique(self.label_column))
        self._index = {v: i for i, v in enumerate(self.classes_)}

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        col = batch[self.label_column]
        codes = []
        for v in np.asarray(col).tolist():
            try:
                codes.append(self._index[v])
            except KeyError:
                raise ValueError(
                    f"LabelEncoder({self.label_column!r}): value {v!r} was not "
                    f"seen during fit (classes: {self.classes_})"
                ) from None
        out[self.label_column] = np.asarray(codes)
        return out


class OneHotEncoder(Preprocessor):
    """Categorical columns -> <col>_<value> indicator columns."""

    def __init__(self, columns: list):
        self.columns = list(columns)

    def _fit(self, ds):
        self.categories_ = {col: sorted(ds.unique(col)) for col in self.columns}

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        for col in self.columns:
            values = np.asarray(batch[col])
            for cat in self.categories_[col]:
                out[f"{col}_{cat}"] = (values == cat).astype(np.int64)
            del out[col]
        return out


class SimpleImputer(Preprocessor):
    """Fill NaNs with mean ("mean" strategy) or a constant."""

    def __init__(self, columns: list, strategy: str = "mean", fill_value=None):
        if strategy not in ("mean", "constant"):
            raise ValueError("strategy must be 'mean' or 'constant'")
        if strategy == "constant" and fill_value is None:
            raise ValueError("constant strategy requires fill_value")
        self.columns = list(columns)
        self.strategy = strategy
        self.fill_value = fill_value

    def _fit(self, ds):
        if self.strategy == "mean":
            # NaN-skipping distributed mean (plain Mean would be poisoned).
            res = ds.aggregate(*[_NanMean(col) for col in self.columns])
            self.fill_ = {col: res[f"nanmean({col})"] for col in self.columns}
        else:
            self.fill_ = {col: self.fill_value for col in self.columns}

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        for col in self.columns:
            arr = np.asarray(batch[col], dtype=np.float64)
            out[col] = np.where(np.isnan(arr), self.fill_[col], arr)
        return out


def _is_nan(v) -> bool:
    try:
        return bool(np.isnan(v))
    except TypeError:
        return False


class _NanMean(AggregateFn):
    """Mean over non-NaN/non-None values; 0.0 if every value is missing."""

    def __init__(self, on: str):
        def accumulate(a, row):
            v = row.get(on)
            if v is None or _is_nan(v):
                return a
            return (a[0] + float(v), a[1] + 1)

        super().__init__(
            init=lambda k: (0.0, 0),
            accumulate=accumulate,
            merge=lambda a, b: (a[0] + b[0], a[1] + b[1]),
            finalize=lambda a: a[0] / a[1] if a[1] else 0.0,
            name=f"nanmean({on})",
        )


class Concatenator(Preprocessor):
    """Concatenate feature columns into one 2-D matrix column — the layout
    a model wants (one big array for one matmul, not a dict of slivers)."""

    _is_fittable = False

    def __init__(self, columns: Optional[list] = None, output_column_name: str = "concat_out", dtype=np.float32, exclude: Optional[list] = None):
        self.columns = list(columns) if columns else None
        self.output_column_name = output_column_name
        self.dtype = dtype
        self.exclude = set(exclude or [])

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        cols = self.columns or [c for c in batch if c not in self.exclude]
        mats = []
        for c in cols:
            arr = np.asarray(batch[c], dtype=self.dtype)
            n = arr.shape[0] if arr.ndim else 0
            # reshape(0, -1) is a numpy error; empty blocks keep width 0.
            mats.append(arr.reshape(n, -1) if arr.size else arr.reshape(n, 0))
        out = {k: v for k, v in batch.items() if k not in cols}
        out[self.output_column_name] = np.concatenate(mats, axis=1) if mats else np.zeros((0, 0), self.dtype)
        return out


class BatchMapper(Preprocessor):
    """Arbitrary stateless batch UDF as a preprocessor."""

    _is_fittable = False

    def __init__(self, fn: Callable[[dict], dict]):
        self.fn = fn

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        return self.fn(batch)


class Chain(Preprocessor):
    """Sequential composition; fit_transform is applied stage by stage so
    later stages fit on earlier stages' output (reference: chain.py)."""

    def __init__(self, *preprocessors: Preprocessor):
        self.preprocessors = list(preprocessors)

    def fit(self, ds):
        for p in self.preprocessors[:-1]:
            ds = p.fit_transform(ds).materialize()
        if self.preprocessors:
            self.preprocessors[-1].fit(ds)
        self._fitted = True
        return self

    def fit_transform(self, ds):
        for p in self.preprocessors:
            ds = p.fit_transform(ds).materialize()
        self._fitted = True
        return ds

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        for p in self.preprocessors:
            batch = p.transform_batch(batch)
        return batch

    def _check_fitted(self):
        for p in self.preprocessors:
            p._check_fitted()


# Extended families (discretizers, hashers, vectorizers, tokenizer, extra
# scalers/encoders, row normalizer, power transform) live in their own
# module; imported last so they can use this module's helpers.
from ray_tpu_torch.data.preprocessors.extended import (  # noqa: E402,F401
    CountVectorizer,
    CustomKBinsDiscretizer,
    FeatureHasher,
    HashingVectorizer,
    MaxAbsScaler,
    MultiHotEncoder,
    Normalizer,
    OrdinalEncoder,
    PowerTransformer,
    RobustScaler,
    Tokenizer,
    UniformKBinsDiscretizer,
)
