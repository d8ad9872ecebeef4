"""Extended preprocessor families.

Analogs of the reference's remaining preprocessor modules
(python/ray/data/preprocessors/): discretizer.py (uniform/custom K-bins),
hasher.py (FeatureHasher), normalizer.py (row-wise Normalizer),
tokenizer.py, vectorizer.py (Count/Hashing vectorizers), transformer.py
(PowerTransformer), scaler.py extras (MaxAbsScaler, RobustScaler), and
encoder.py extras (OrdinalEncoder, MultiHotEncoder).

Hash-based features use crc32 (stable across processes — Python's builtin
``hash`` is salted per interpreter and would scatter tokens differently on
every worker). RobustScaler fits percentiles from a bounded per-column
reservoir sample folded in one distributed aggregation pass.
"""

from __future__ import annotations

import re
import zlib
from typing import Callable, List, Optional

import numpy as np

from ray_tpu_torch.data.aggregate import AggregateFn, Max, Min
from ray_tpu_torch.data.preprocessor import Preprocessor
from ray_tpu_torch.data.preprocessors import _safe_scale


def _stable_hash(token: str, buckets: int) -> int:
    return zlib.crc32(str(token).encode("utf-8")) % buckets


def default_tokenizer(text: str) -> List[str]:
    return [t for t in re.split(r"[^0-9a-zA-Z]+", str(text).lower()) if t]


class _Reservoir(AggregateFn):
    """Bounded uniform sample of one column (Vitter's algorithm R), merged
    across blocks — feeds driver-side percentile fits in one pass."""

    def __init__(self, on: str, k: int = 4096, seed: int = 0):
        def accumulate(state, row):
            sample, n = state
            v = row.get(on)
            if v is None:
                return state
            n += 1
            if len(sample) < k:
                return (sample + [float(v)], n)
            # RNG only on the (increasingly rare) replacement path — per-row
            # generator construction dominated the fit otherwise.
            rng = np.random.default_rng((seed + n) & 0xFFFFFFFF)
            j = int(rng.integers(0, n))
            if j < k:
                sample = list(sample)
                sample[j] = float(v)
            return (sample, n)

        def merge(a, b):
            sa, na = a
            sb, nb = b
            n = na + nb
            pooled = sa + sb
            if len(pooled) <= k:
                return (pooled, n)
            # Weighted union: each slot draws from a side with probability
            # proportional to that side's OBSERVED count — uniform choice
            # over the pooled values would overweight small blocks by the
            # ratio of their sampling rates.
            rng = np.random.default_rng((seed + n) & 0xFFFFFFFF)
            ia, ib = list(sa), list(sb)
            rng.shuffle(ia)
            rng.shuffle(ib)
            out = []
            for _ in range(k):
                pick_a = ia and (not ib or rng.random() < na / (na + nb))
                out.append(ia.pop() if pick_a else ib.pop())
            return (out, n)

        super().__init__(
            init=lambda key: ([], 0),
            accumulate=accumulate,
            merge=merge,
            finalize=lambda a: a[0],
            name=f"reservoir({on})",
        )


class MaxAbsScaler(Preprocessor):
    """x / max|x| per column (reference: scaler.py MaxAbsScaler)."""

    def __init__(self, columns: list):
        self.columns = list(columns)

    def _fit(self, ds):
        from ray_tpu_torch.data.aggregate import AbsMax

        res = ds.aggregate(*[AbsMax(col) for col in self.columns])
        self.stats_ = {c: _safe_scale(res[f"abs_max({c})"]) for c in self.columns}

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        for col in self.columns:
            out[col] = np.asarray(batch[col], np.float64) / self.stats_[col]
        return out


class RobustScaler(Preprocessor):
    """(x - median) / IQR per column, quantiles from a one-pass reservoir
    sample (reference: scaler.py RobustScaler)."""

    def __init__(self, columns: list, *, quantile_range: tuple = (0.25, 0.75)):
        self.columns = list(columns)
        self.quantile_range = quantile_range

    def _fit(self, ds):
        res = ds.aggregate(*[_Reservoir(col) for col in self.columns])
        lo_q, hi_q = self.quantile_range
        self.stats_ = {}
        for col in self.columns:
            sample = np.asarray(res[f"reservoir({col})"], np.float64)
            if sample.size == 0:
                self.stats_[col] = (0.0, 1.0)
                continue
            med = float(np.median(sample))
            iqr = float(np.quantile(sample, hi_q) - np.quantile(sample, lo_q))
            self.stats_[col] = (med, _safe_scale(iqr))

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        for col in self.columns:
            med, iqr = self.stats_[col]
            out[col] = (np.asarray(batch[col], np.float64) - med) / iqr
        return out


class UniformKBinsDiscretizer(Preprocessor):
    """Equal-width binning into integer codes 0..bins-1 (reference:
    discretizer.py UniformKBinsDiscretizer)."""

    def __init__(self, columns: list, bins: int):
        self.columns = list(columns)
        self.bins = int(bins)

    def _fit(self, ds):
        aggs = []
        for col in self.columns:
            aggs += [Min(col), Max(col)]
        res = ds.aggregate(*aggs)
        self.edges_ = {}
        for col in self.columns:
            lo, hi = float(res[f"min({col})"]), float(res[f"max({col})"])
            self.edges_[col] = np.linspace(lo, hi, self.bins + 1)

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        for col in self.columns:
            edges = self.edges_[col]
            codes = np.digitize(np.asarray(batch[col], np.float64), edges[1:-1])
            out[col] = codes.astype(np.int64)
        return out


class CustomKBinsDiscretizer(Preprocessor):
    """Binning with caller-provided edges (reference: discretizer.py
    CustomKBinsDiscretizer)."""

    _is_fittable = False

    def __init__(self, columns: list, bin_edges: list):
        self.columns = list(columns)
        self.bin_edges = np.asarray(bin_edges, np.float64)

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        for col in self.columns:
            out[col] = np.digitize(
                np.asarray(batch[col], np.float64), self.bin_edges
            ).astype(np.int64)
        return out


class Normalizer(Preprocessor):
    """Row-wise normalization ACROSS the given columns (reference:
    normalizer.py): each row's [col...] vector is scaled to unit l1/l2/max
    norm."""

    _is_fittable = False

    def __init__(self, columns: list, norm: str = "l2"):
        if norm not in ("l1", "l2", "max"):
            raise ValueError("norm must be l1|l2|max")
        self.columns = list(columns)
        self.norm = norm

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        mat = np.stack(
            [np.asarray(batch[c], np.float64) for c in self.columns], axis=1
        )
        if self.norm == "l1":
            denom = np.abs(mat).sum(axis=1)
        elif self.norm == "l2":
            denom = np.sqrt((mat**2).sum(axis=1))
        else:
            denom = np.abs(mat).max(axis=1)
        denom = np.where(denom == 0, 1.0, denom)
        for i, c in enumerate(self.columns):
            out[c] = mat[:, i] / denom
        return out


class PowerTransformer(Preprocessor):
    """Box-Cox / Yeo-Johnson with a caller-provided power (reference:
    transformer.py PowerTransformer — power is an argument, not fitted)."""

    _is_fittable = False

    def __init__(self, columns: list, power: float, method: str = "yeo-johnson"):
        if method not in ("yeo-johnson", "box-cox"):
            raise ValueError("method must be yeo-johnson|box-cox")
        self.columns = list(columns)
        self.power = float(power)
        self.method = method

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        lmbda = self.power
        for col in self.columns:
            x = np.asarray(batch[col], np.float64)
            if self.method == "box-cox":
                out[col] = np.log(x) if lmbda == 0 else (x**lmbda - 1) / lmbda
            else:
                pos = x >= 0
                if lmbda == 0:
                    y_pos = np.log1p(np.where(pos, x, 0))
                else:
                    y_pos = ((np.where(pos, x, 0) + 1) ** lmbda - 1) / lmbda
                if lmbda == 2:
                    y_neg = -np.log1p(np.where(pos, 0, -x))
                else:
                    y_neg = -(((np.where(pos, 0, -x) + 1) ** (2 - lmbda) - 1) / (2 - lmbda))
                out[col] = np.where(pos, y_pos, y_neg)
        return out


class OrdinalEncoder(Preprocessor):
    """Each categorical column -> integer codes by sorted category order
    (reference: encoder.py OrdinalEncoder)."""

    def __init__(self, columns: list):
        self.columns = list(columns)

    def _fit(self, ds):
        self.categories_ = {c: sorted(ds.unique(c)) for c in self.columns}
        self._index = {
            c: {v: i for i, v in enumerate(vals)} for c, vals in self.categories_.items()
        }

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        for col in self.columns:
            index = self._index[col]
            try:
                out[col] = np.asarray(
                    [index[v] for v in np.asarray(batch[col]).tolist()], np.int64
                )
            except KeyError as e:
                raise ValueError(
                    f"OrdinalEncoder({col!r}): unseen value {e.args[0]!r}"
                ) from None
        return out


class MultiHotEncoder(Preprocessor):
    """Column of LISTS -> [N, num_classes] indicator matrix (reference:
    encoder.py MultiHotEncoder)."""

    def __init__(self, columns: list):
        self.columns = list(columns)

    def _fit(self, ds):
        self.classes_ = {}
        for col in self.columns:
            values = set()
            for row in ds.select_columns([col]).take_all():
                cell = row[col]
                if cell is None:
                    continue
                # Cells come back as lists OR numpy arrays depending on the
                # block lane; np truthiness is ambiguous, so iterate plainly.
                values.update(np.asarray(cell).tolist())
            self.classes_[col] = sorted(values)

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        for col in self.columns:
            classes = self.classes_[col]
            index = {v: i for i, v in enumerate(classes)}
            rows = batch[col]
            mat = np.zeros((len(rows), len(classes)), np.int64)
            for r, values in enumerate(rows):
                if values is None:
                    continue
                for v in np.asarray(values).tolist():
                    j = index.get(v)
                    if j is not None:
                        mat[r, j] = 1
            out[col] = mat
        return out


class Tokenizer(Preprocessor):
    """String column -> list of tokens (reference: tokenizer.py)."""

    _is_fittable = False

    def __init__(self, columns: list, tokenization_fn: Optional[Callable] = None):
        self.columns = list(columns)
        self.fn = tokenization_fn or default_tokenizer

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        for col in self.columns:
            out[col] = np.asarray(
                [self.fn(v) for v in np.asarray(batch[col]).tolist()], dtype=object
            )
        return out


class CountVectorizer(Preprocessor):
    """Text column -> per-token count columns ``<col>_<token>`` for the
    ``max_features`` most frequent tokens (reference: vectorizer.py)."""

    def __init__(self, columns: list, tokenization_fn: Optional[Callable] = None,
                 max_features: Optional[int] = None):
        self.columns = list(columns)
        self.fn = tokenization_fn or default_tokenizer
        self.max_features = max_features

    def _fit(self, ds):
        fn = self.fn

        class _TokenCounts(AggregateFn):
            def __init__(self, on):
                def accumulate(counts, row):
                    counts = dict(counts)
                    for t in fn(row.get(on) or ""):
                        counts[t] = counts.get(t, 0) + 1
                    return counts

                def merge(a, b):
                    out = dict(a)
                    for t, n in b.items():
                        out[t] = out.get(t, 0) + n
                    return out

                super().__init__(
                    init=lambda key: {},
                    accumulate=accumulate,
                    merge=merge,
                    finalize=lambda a: a,
                    name=f"tokens({on})",
                )

        res = ds.aggregate(*[_TokenCounts(col) for col in self.columns])
        self.vocabularies_ = {}
        for col in self.columns:
            counts = res[f"tokens({col})"]
            vocab = sorted(counts, key=lambda t: (-counts[t], t))
            if self.max_features:
                vocab = vocab[: self.max_features]
            self.vocabularies_[col] = sorted(vocab)

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        for col in self.columns:
            vocab = self.vocabularies_[col]
            index = {t: i for i, t in enumerate(vocab)}
            texts = np.asarray(batch[col]).tolist()
            mat = np.zeros((len(texts), len(vocab)), np.int64)
            for r, text in enumerate(texts):
                for t in self.fn(text or ""):
                    j = index.get(t)
                    if j is not None:
                        mat[r, j] += 1
            for i, t in enumerate(vocab):
                out[f"{col}_{t}"] = mat[:, i]
            del out[col]
        return out


class HashingVectorizer(Preprocessor):
    """Text column -> fixed ``num_features`` hashed count columns; no fit,
    no vocabulary state (reference: vectorizer.py HashingVectorizer)."""

    _is_fittable = False

    def __init__(self, columns: list, num_features: int,
                 tokenization_fn: Optional[Callable] = None):
        self.columns = list(columns)
        self.num_features = int(num_features)
        self.fn = tokenization_fn or default_tokenizer

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        for col in self.columns:
            texts = np.asarray(batch[col]).tolist()
            mat = np.zeros((len(texts), self.num_features), np.int64)
            for r, text in enumerate(texts):
                for t in self.fn(text or ""):
                    mat[r, _stable_hash(t, self.num_features)] += 1
            for i in range(self.num_features):
                out[f"{col}_hash_{i}"] = mat[:, i]
            del out[col]
        return out


class FeatureHasher(Preprocessor):
    """Hash (column name, value) pairs of the given columns into
    ``num_features`` buckets (reference: hasher.py FeatureHasher)."""

    _is_fittable = False

    def __init__(self, columns: list, num_features: int,
                 output_column_name: str = "hashed_features"):
        self.columns = list(columns)
        self.num_features = int(num_features)
        self.output_column_name = output_column_name

    def _transform_pandas_or_dict(self, batch: dict) -> dict:
        out = dict(batch)
        n = len(np.asarray(batch[self.columns[0]]))
        mat = np.zeros((n, self.num_features), np.float64)
        for col in self.columns:
            values = np.asarray(batch[col]).tolist()
            for r, v in enumerate(values):
                mat[r, _stable_hash(f"{col}={v}", self.num_features)] += 1
        for col in self.columns:
            del out[col]
        out[self.output_column_name] = mat
        return out
